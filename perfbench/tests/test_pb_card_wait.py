"""The reader of `card_wait_us_per_read`: the stage profile's
`<stage>_fetch` seconds, and only those, summed in microseconds a read."""
import pytest

from perfbench.lib import spec
from perfbench.lib.harness import Ctx

S = spec.Spec()


def ctx(timings, reads=1000):
    return Ctx(timings=timings, transfer_bytes={"upload": 1, "fetch": 1},
               reads=reads, slice=None, slice_wall_s=0.0, launches=[],
               device_name="cpu")


@pytest.mark.parametrize("timings,reads,want", [
    # three waits, 4 ms over 1,000 reads; the stages around them not
    ({"segment": 0.010, "segment_fetch": 0.0015, "adaptive": 0.030,
      "adaptive_fetch": 0.002, "finalize_fetch": 0.0005}, 1000, 4.0),
    ({"adaptive_fetch": 0.0}, 10, 0.0),
    ({"other_fetch": 0.001, "io_map": 5.0}, 100, 10.0),
    # no wait timed, or no read profiled: nothing
    ({"segment": 0.010, "delfix_plan": 0.004}, 1000, None),
    ({"segment_fetch": 0.001}, 0, None),
])
def test_card_wait(timings, reads, want):
    got = S.reader("card_wait_us_per_read")(ctx(timings, reads))
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want)


def test_card_wait_is_listed_for_every_cell():
    (m,) = [m for m in S.data["per_layer"]
            if m["name"] == "card_wait_us_per_read"]
    assert m["workloads"] == [w["name"] for w in S.data["workloads"]]
    assert (m["unit"], m["source"], m["moves"]) == (
        "us/read", "program_span", "bases_per_s")
