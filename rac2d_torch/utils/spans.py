"""Named host-time spans: where a run's host time goes, by the program's
own names.

``with span("chem.rhs"): ...`` charges the host time spent inside the
block to "chem.rhs" and counts one entry.  The time is exclusive (self):
while a span is open inside another, the inner one alone is charged, so
the spans open in a block add up to the block's wall time.  Time outside
every span is charged to none.  The accumulators are process-wide and
always on: each boundary costs one clock read (``time.perf_counter_ns``)
and a check of the profiler's flag (a span, enter and exit, 1.2-1.8 µs on
an H100 machine's host).  Spans are opened by one thread, the one that
drives the solver.

``reset()`` zeroes the table and ``totals()`` reads it, in the idiom of
``ops/kernels.py``'s ``reset_launches()`` and ``launch_counts()``.  A
span opened with ``keep=True`` (a chemistry sweep) also keeps the table
of what ran inside it, its own entry included, for a reader that did
not see it start; ``kept()`` gives the last ``KEEP`` of those.

While ``torch.profiler`` records, and only then, each span also opens
``torch.profiler.record_function(name)``, so that the spans sit in the
trace on the same clock as the operators and kernels they launch.  With
no profiler running no ``record_function`` is entered (it costs about
ten microseconds even then).

The names used by the port (the chemistry path's are the contract of its
per-layer metrics):

- ``chem.sweep``: ``DiskModel.chemistry_step`` outside the spans below
  (kept);
- ``chem.shield``: ``prepare_sweep_fields`` (columns, shielding, its
  closing synchronize); ``chem.envs``: each environment assembly;
- ``chem.pool``: the sweep's host loop around the BDF rounds: tolerance
  ladder, batch set-up, flush, refill, ladder roll-back, write-back;
- ``chem.step``: one BDF round (predict, refresh decisions, error test,
  order and step adaptation, dense-output recording), inside which
  ``chem.rhs`` (each Newton right-hand side), ``chem.jac`` (each
  Jacobian), ``chem.factor`` (``bdf._bfac``), ``chem.solve``
  (``bdf._bsolve``);
- ``chem.rhs.graph``: a marker with an empty body, entered inside
  ``chem.rhs`` once for each right-hand side replayed from its CUDA
  graph (``ops/odesys.py``; never on the CPU);
- ``chem.sync``: each device-to-host read and each all-reduce of a
  decision on the chemistry path (in ``chem.step`` and ``chem.pool``);
- ``chem.eqT``: the equilibrium gas temperature (``evolT=False``),
  inside which ``chem.eqT.eval`` (each evaluation of the net heating:
  rates and heating minus cooling, ``ThermalBalance.solve_equilibrium_T``)
  and ``chem.eqT.read`` (each read back of its loops' tests); its
  windows' environment assembly is ``chem.envs``;
- ``mc.*``: the streamed Monte Carlo pass's stages (``ops/mcrt.py``).
"""

from __future__ import annotations

import collections
import time

import torch
from torch.profiler import record_function

# the tables of kept spans that kept() holds, newest last
KEEP = 16

_clock = time.perf_counter_ns
_profiling = torch._C._autograd._profiler_enabled

# name -> [self ns, entries]
_table: dict[str, list] = {}
# the accumulators of the open spans, innermost last
_stack: list[list] = []
# the clock at the last boundary of any span
_last = [0]
_kept: collections.deque = collections.deque(maxlen=KEEP)


class span:
    """with span(name) as s: ...  Charges the block's self time to name
    and counts one entry; after the block, s.seconds is its inclusive
    wall time.  keep=True also keeps the table of what ran inside it
    (kept())."""

    __slots__ = ("name", "keep", "seconds", "_t0", "_snap", "_rf")

    def __init__(self, name: str, keep: bool = False):
        self.name = name
        self.keep = keep
        self.seconds = 0.0

    def __enter__(self):
        now = _clock()
        if _stack:
            _stack[-1][0] += now - _last[0]
        _last[0] = now
        self._t0 = now
        if self.keep:
            self._snap = {k: (v[0], v[1]) for k, v in _table.items()}
        acc = _table.get(self.name)
        if acc is None:
            acc = _table[self.name] = [0, 0]
        acc[1] += 1
        _stack.append(acc)
        if _profiling():
            self._rf = record_function(self.name)
            self._rf.__enter__()
        else:
            self._rf = None
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
        now = _clock()
        _stack.pop()[0] += now - _last[0]
        _last[0] = now
        self.seconds = (now - self._t0) / 1e9
        if self.keep:
            snap = self._snap
            self._snap = None
            _kept.append((self.name, _table_since(snap)))
        return False


def _table_since(snap):
    out = {}
    for k, (ns, n) in _table.items():
        ns0, n0 = snap.get(k, (0, 0))
        if n > n0 or ns > ns0:
            out[k] = ((ns - ns0) / 1e9, n - n0)
    return out


def reset():
    """Zero every span's self time and entries, and forget the kept
    tables (call it with no span open)."""
    for acc in _table.values():
        acc[0] = acc[1] = 0
    _kept.clear()


def totals() -> dict[str, tuple[float, int]]:
    """{name: (self seconds, entries)} since the last reset()."""
    return {k: (v[0] / 1e9, v[1]) for k, v in _table.items()
            if v[0] or v[1]}


def inside(name: str) -> bool:
    """Whether the innermost open span is name."""
    return bool(_stack) and _stack[-1] is _table.get(name)


def kept() -> list[tuple[str, dict[str, tuple[float, int]]]]:
    """The last KEEP spans opened with keep=True, oldest first: (name,
    {name: (self seconds, entries)} of every span that ran inside it,
    its own included)."""
    return list(_kept)
