"""Faults planted under the timed path, each of which the check has to
find: ``plant(name)`` patches ``BatchedResquiggler`` and returns a function
that takes the patch out again.  The benchmark's own runs plant none; the
tests and ``perfbench/calibrate.py`` do."""
from __future__ import annotations

from typing import Callable

from perfbench.lib import program


def _half_left_out(orig):
    def fn(self, map_results, **kw):
        n = len(map_results) // 2
        return orig(self, map_results[:n], **kw) + \
            [(None, "left out")] * (len(map_results) - n)
    return fn


def _fit_unchanged(every: int):
    """The sequence-fitted rescaling returns a read's scale values
    unchanged, on every ``every``-th read of a batch."""
    def plant(orig):
        def fn(self, states, will_retry=False):
            before = {id(s): s.scale_values for s in states}
            orig(self, states, will_retry)
            for s in states:
                if (s.idx % every == 0 and s.result is not None and
                        before[id(s)] is not None):
                    s.result = s.result.replace(
                        scale_values=before[id(s)], norm_params_changed=False)
        return fn
    return plant


def _answer_altered(orig):
    def fn(self, states, will_retry=False):
        orig(self, states, will_retry)
        for s in states:
            if s.result is not None:
                segs = s.result.segs.copy()
                segs[1:-1] += 1
                s.result = s.result.replace(segs=segs)
    return fn


FAULTS = {"half_the_batch_left_out": ("resquiggle_batch", _half_left_out),
          "rescaling_returns_its_state_unchanged": ("_finalize",
                                                    _fit_unchanged(1)),
          "rescaling_unchanged_on_a_third": ("_finalize", _fit_unchanged(3)),
          "answers_altered_where_produced": ("_finalize", _answer_altered)}


def plant(name: str) -> Callable[[], None]:
    cls = program.timed_class()
    attr, make = FAULTS[name]
    orig = getattr(cls, attr)
    setattr(cls, attr, make(orig))

    def undo():
        setattr(cls, attr, orig)
    return undo
