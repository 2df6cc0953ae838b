"""The per-layer readers on a canned stage profile and a canned device
trace, and the roofline counters on shapes worked by hand."""
import json

import pytest

from perfbench.lib import roofline, spec
from perfbench.lib.harness import Ctx
from perfbench.lib.trace import Slice

S = spec.Spec()
H100 = "NVIDIA H100 80GB HBM3"

EVENTS = [
    # host stage ranges (us)
    {"ph": "X", "cat": "user_annotation", "name": "segment", "ts": 0,
     "dur": 400},
    {"ph": "X", "cat": "user_annotation", "name": "adaptive", "ts": 400,
     "dur": 600},
    # device operations: 100-200 and 150-250 overlap, 700-800
    {"ph": "X", "cat": "kernel", "name": "void banded_dp_kernel<2, false>",
     "ts": 100, "dur": 100},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 150,
     "dur": 100},
    {"ph": "X", "cat": "kernel", "name": "count_le_kernel(int const*)",
     "ts": 700, "dur": 100},
    {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 10, "dur": 5},
]


def ctx(**kw):
    base = dict(timings={"plan": 0.002, "segment": 0.010, "start": 0.002,
                         "adaptive": 0.030, "delfix_plan": 0.004,
                         "delfix_apply": 0.001,
                         "finalize": 0.008},
                transfer_bytes={"upload": 2_000_000, "fetch": 100},
                reads=1000, slice=Slice(EVENTS), slice_wall_s=0.001,
                launches=[], device_name=H100)
    base.update(kw)
    return Ctx(**base)


@pytest.mark.parametrize("name,want", [
    ("plan_us_per_read", 2.0), ("segment_us_per_read", 12.0),
    ("upload_bytes_per_read", 2000.0), ("adaptive_us_per_read", 30.0),
    ("delfix_host_us_per_read", 5.0),
    ("finalize_us_per_read", 8.0),
    # busy union 100-250 and 700-800: 250 us of a 1,000 us slice
    ("device_idle_share", 75.0)])
def test_reader_arithmetic(name, want):
    assert S.reader(name)(ctx()) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(
    m["name"] for m in S.data["per_layer"]))
def test_readers_return_nothing_without_data(name):
    empty = ctx(timings={}, transfer_bytes={}, reads=0, slice=None,
                slice_wall_s=0.0)
    assert S.reader(name)(empty) is None


def test_slice_busy_ops_and_idle_by_stage():
    sl = Slice(EVENTS)
    assert sl.busy() == [(100.0, 250.0), (700.0, 800.0)]
    assert sl.busy_s() == pytest.approx(250e-6)
    ops = dict(sl.device_ops())
    assert ops["void banded_dp_kernel<2, false>"] == pytest.approx(100e-6)
    # gaps 0-100 and 250-400 in segment; 400-700 and 800-1000 in adaptive
    idle = dict(sl.idle_by_stage())
    assert idle == pytest.approx({"segment": 250e-6, "adaptive": 500e-6})
    assert sl.kernel_s(("banded_dp_kernel",)) == pytest.approx(100e-6)


def test_slice_loads_chrome_json(tmp_path):
    p = tmp_path / "t.pt.trace.json"
    p.write_text(json.dumps({"traceEvents": EVENTS}))
    assert Slice.load(str(p)).busy_s() == pytest.approx(250e-6)


def test_dp_work_by_hand():
    # 2 reads of 10 and 20 rows (L 16: the second counts 16), bw 4
    w = roofline.dp_work({"B": 2, "E": 30, "L": 16, "bw": 4, "R": 16,
                          "P": 3, "rows": [10, 20]})
    assert w["ops"] == (10 + 16) * 4 * 20
    assert w["bytes"] == (2 * 30 * 4 + 4 * 2 * 4 + 2 * 2 * 16 * 4 +
                          2 * 2 * 3 * 4 + 2 * 17 * 4 + 2 * 2 + 2 * 4 * 4)


def test_count_le_work_and_share_by_hand():
    w = roofline.count_le_work({"B": 512, "M": 523776, "P": 8})
    assert w["bytes"] == 4 * 512 * 523776 + 8 * 512 * 8
    assert w["ops"] == 512 * 523776 * 8
    least = roofline.least_seconds(w["bytes"], w["ops"], H100)
    assert least == pytest.approx(w["bytes"] / 3.35e12)
    assert roofline.share([w], 2 * least, H100) == pytest.approx(50.0)
    assert roofline.share([], 1.0, H100) is None
    assert roofline.share([w], 0.0, H100) is None


def test_roofline_reader_on_recorded_launches():
    launches = [{"kernel": "count_le", "B": 1, "M": 335, "P": 10}]
    # 1,420 bytes at 3.35e12 B/s = 0.4239 ns against 100 us of K5
    c = ctx(launches=launches)
    want = 100.0 * (4 * 335 + 80) / 3.35e12 / 100e-6
    assert S.reader("count_le_roofline")(c) == pytest.approx(want)
    assert S.reader("banded_dp_roofline")(c) is None
