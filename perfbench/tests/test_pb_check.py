"""The check that decides ``correct``: its arithmetic, the bfloat16
control (the reference in the program's place, one precision below the
configuration's float32) failing each cell's limits, and a run whose
timed path is broken underneath coming out not correct, once for each
fault a cell can have.  On the CPU at a size a test can hold: the cells'
own configurations and limits, a few short reads."""
import numpy as np
import pytest

from perfbench.lib import check, faults, harness, spec, traffic
from perfbench.reference import resquiggle as R
from tiny import tiny_copy

S = spec.Spec()
CELLS = sorted(S.cells)


def fields(start, segs, shift=0.0, scale=1.0, score=0.3):
    return {"start": start, "segs": np.asarray(segs), "shift": shift,
            "scale": scale, "score": score}


def test_compare_by_hand():
    want = [fields(10, [0, 5, 9, 14], 1.0, 2.0, 0.30), None,
            fields(3, [0, 4, 8], 0.0, 1.0, 0.20), fields(0, [0, 2, 4]), None,
            fields(0, [0, 3, 6], 0.0, 1.0, 0.20)]
    got = [fields(10, [0, 5, 10, 14], 1.002, 2.0, 0.31),
           fields(0, [0, 1, 2]), fields(4, [0, 4, 8], 0.0, 1.0, 0.20), None,
           None, fields(0, [0, 3, 6], 0.0, 1.0, 0.2 + check.SCORE_BAR / 2)]
    n = check.compare(got, want)
    # read 0: 1 of 4 boundaries; read 1 and read 3: one side fails, all 3
    # count; read 2: its start one later, all 3 differ; read 4: both fail;
    # read 5: none of 3
    assert n["boundary_mismatch"] == pytest.approx(10 / 16)
    # read 0: scale gap 0.001, score gap 0.01; reads 1 and 3 off (one side
    # fails); reads 2 and 5 under both bars
    gaps = check.read_gaps(got, want)
    assert [g[:2] for g in gaps] == [(4, 1), (3, 3), (3, 3), (3, 3), (3, 0)]
    assert gaps[0][2] == pytest.approx(0.001)
    assert gaps[0][3] == pytest.approx(0.01)
    off0 = gaps[0][2] > check.SCALE_BAR or gaps[0][3] > check.SCORE_BAR
    assert n["reads_off"] == pytest.approx((2 + off0) / 5)
    lim = {"boundary_mismatch": 0.8, "reads_off": 0.6}
    ok, checks = check.judge(n, lim)
    assert ok and list(checks) == list(check.NUMBERS)
    assert checks["reads_off"] == {"value": n["reads_off"], "limit": 0.6}
    assert not check.judge(n, dict(lim, reads_off=0.3))[0]
    assert not check.judge(n, {})[0]
    assert check.compare([None], [None]) == {k: 1.0 for k in check.NUMBERS}
    # each read on its own: a third of the reads off reads a third
    sound = [fields(0, [0, 5], 0.0, 1.0, 0.2)] * 6
    bad = [fields(0, [0, 5], 0.0, 1.0 + 2 * check.SCALE_BAR, 0.2)] * 2
    assert check.compare(sound[:4] + bad, sound) == {
        "boundary_mismatch": 0.0, "reads_off": pytest.approx(1 / 3)}


def test_bf16_rounding():
    x = np.array([1.0, 1.0 + 2 ** -9, 3.14159, -15.0, np.inf])
    y = R.BF16.q(x)
    assert y[0] == 1.0 and y[1] == 1.0 and y[3] == -15.0 and y[4] == np.inf
    assert abs(y[2] - 3.14159) < 2 ** -7 * 4 and y[2] != 3.14159
    assert R.F64.q(x) is x


@pytest.mark.parametrize("name", CELLS)
def test_bf16_control_fails_the_limits(name):
    cell = S.cell(name)
    cfg = S.config(cell)
    t = dict(S.traffic(cell), n_reads=6, batch=6, ref_len=8000,
             lengths={"fixed": 500})
    model = R.KmerModel("%s/reference/models/%s" % (S.bench_dir,
                                                    cfg["model_file"]))
    pool = traffic.make_pool(t, 2 ** 31 + 7, model)
    picks = list(range(len(pool.reads)))
    rna = cfg["sample_type"] == "RNA"
    want = check.reference_fields(check.run_reference(
        check.reference_jobs(pool, picks, cfg, rna, "float64"), 1))
    ctl = check.reference_fields(check.run_reference(
        check.reference_jobs(pool, picks, cfg, rna, "bfloat16"), 1))
    ok, checks = check.judge(check.compare(ctl, want), S.limits(cell))
    assert not ok, checks


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return spec.Spec(tiny_copy(str(tmp_path_factory.mktemp("bench"))))


@pytest.mark.parametrize("name", CELLS)
def test_sound_tiny_run_is_correct(tiny, name):
    line = harness.run_cell(tiny, name, 2 ** 31 + 3, 0.05, False, "cpu",
                            ref_workers=1)
    assert line["correct"] is True, line["checks"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(tiny, name, fault):
    undo = faults.plant(fault)
    try:
        line = harness.run_cell(tiny, name, 2 ** 31 + 3, 0.05, False, "cpu",
                                ref_workers=1)
    finally:
        undo()
    assert line["correct"] is False, line["checks"]
    assert list(line)[-1] == "checks"
