"""The port's host-sharding and merge helpers
(``tombo_tpu_torch/parallel/distributed.py``) against the JAX package's:
the same read -> host assignment, and ``psum_hosts`` over a two-process
gloo group equal to numpy's sum in every process; ``psum_hosts_device``
over 2 and 3 gloo processes on CPU tensors (exact integer sums, float32
bitwise the host path), the merge route chosen at the join (the host
route in CPU processes, and with a card shared) and ``choose_route`` on
fabricated card identities."""
import json
import os
import socket
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

from tombo_tpu.parallel import distributed as j_dist
from tombo_tpu_torch.parallel import distributed as t_dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_read_shard_and_key_match_jax():
    rng = np.random.default_rng(0)
    keys = ["%032x" % rng.integers(0, 2 ** 63) + ("-%d" % i)
            for i in range(1000)]
    for n_hosts in range(1, 9):
        t = [t_dist.read_shard(k, n_hosts) for k in keys]
        assert t == [j_dist.read_shard(k, n_hosts) for k in keys]
        if n_hosts > 1:
            assert set(t) == set(range(n_hosts))
    for rec in (types.SimpleNamespace(read_id="r1", fn="a.fast5", start=5),
                types.SimpleNamespace(read_id="", fn="a.fast5", start=5),
                types.SimpleNamespace(read_id=None, fn="b.fast5", start=0),
                types.SimpleNamespace()):
        assert t_dist.read_key(rec) == j_dist.read_key(rec)


def test_dist_context_matches_jax():
    for n_hosts in (1, 3, 5):
        for host in range(n_hosts):
            t = t_dist.DistContext(n_hosts, host)
            j = j_dist.DistContext(n_hosts, host)
            assert t.is_main == j.is_main
            for k in ("read_a", "read_b", "x:12", "0f3a"):
                assert t.owns_read(k) == j.owns_read(k)
            for r in range(12):
                assert t.owns_region(r) == j.owns_region(r)


def test_single_host_is_a_no_op():
    ctx = t_dist.init_distributed()
    assert ctx == t_dist.DistContext(1, 0)
    assert t_dist.init_distributed("localhost:1", 1, 0) == ctx
    a, b = np.arange(5, dtype=np.int32), np.ones(3, np.float32)
    out = t_dist.psum_hosts(ctx, a, b)
    assert out[0] is a and out[1] is b


_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch.distributed
    from tombo_tpu_torch.parallel import distributed as d
    port, rank = int(sys.argv[1]), int(sys.argv[2])
    ctx = d.init_distributed("127.0.0.1:%d" % port, 2, rank, device="cpu")
    rng = np.random.default_rng(rank)
    ints = rng.integers(0, 10 ** 6, (3, 5))
    f32 = rng.normal(0, 1, 7).astype(np.float32)
    tot_i, tot_f = d.psum_hosts(ctx, ints, f32)
    torch.distributed.destroy_process_group()
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "tombo_tpu"))
    print(json.dumps({"ctx": [ctx.n_hosts, ctx.host_id], "bad": bad,
                      "ints": tot_i.tolist(), "int_dtype": str(tot_i.dtype),
                      "f32": tot_f.tolist(), "f32_dtype": str(tot_f.dtype)}))
""")


def test_psum_hosts_two_gloo_processes():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(port), str(rank)], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    parts = [np.random.default_rng(rank) for rank in range(2)]
    ints = [r.integers(0, 10 ** 6, (3, 5)) for r in parts]
    f32 = [r.normal(0, 1, 7).astype(np.float32) for r in parts]
    for rank, got in enumerate(outs):
        assert got["ctx"] == [2, rank] and got["bad"] == []
        assert got["int_dtype"] == "int64" and got["f32_dtype"] == "float32"
        np.testing.assert_array_equal(got["ints"], np.sum(ints, axis=0))
        np.testing.assert_array_equal(np.array(got["f32"], np.float32),
                                      np.sum(np.stack(f32), axis=0))


_DEVICE_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch.distributed
    from tombo_tpu_torch.parallel import distributed as d
    port, rank, n, shared = (int(a) for a in sys.argv[1:5])
    if shared:
        d.card_identity = lambda device: "GPU-one-card"
    ctx = d.init_distributed("127.0.0.1:%d" % port, n, rank, device="cpu")
    rng = np.random.default_rng(rank)
    ints = rng.integers(0, 10 ** 6, (3, 5)).astype(np.int32)
    f32 = rng.normal(0, 1, 7).astype(np.float32)
    dev_i, dev_f = d.psum_hosts_device(ctx, ints, f32)
    host_i, host_f = d.psum_hosts(ctx, ints, f32)
    path = d.LAST_PSUM_PATH["path"]
    torch.distributed.destroy_process_group()
    print(json.dumps({"route": ctx.route, "path": path,
                      "ctx_device": str(ctx.device),
                      "ints": dev_i.tolist(), "int_dtype": str(dev_i.dtype),
                      "f32_hex": dev_f.tobytes().hex(),
                      "f32_dtype": str(dev_f.dtype),
                      "host_ints": host_i.tolist(),
                      "host_f32_hex": host_f.tobytes().hex()}))
""")


def _run_hosts(script, n, *extra):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(port), str(rank), str(n)] +
        [str(e) for e in extra], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in range(n)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


@pytest.mark.parametrize("n,shared", [(2, 0), (3, 1)])
def test_psum_hosts_device_gloo_processes(n, shared):
    """On CPU tensors over the gloo group: integer totals exact in int64,
    float32 totals bitwise ``psum_hosts``'s (and numpy's sum in rank
    order); CPU processes, and processes that share one card, take the
    host route."""
    outs = _run_hosts(_DEVICE_WORKER, n, shared)
    parts = [np.random.default_rng(rank) for rank in range(n)]
    ints = [r.integers(0, 10 ** 6, (3, 5)).astype(np.int32) for r in parts]
    f32 = [r.normal(0, 1, 7).astype(np.float32) for r in parts]
    want_f = f32[0].copy()
    for f in f32[1:]:
        want_f += f
    for got in outs:
        assert got["route"] == "host" and got["path"] == "host"
        assert got["ctx_device"] == "None"
        assert got["int_dtype"] == "int64" and got["f32_dtype"] == "float32"
        np.testing.assert_array_equal(got["ints"],
                                      np.sum(ints, axis=0, dtype=np.int64))
        assert got["host_ints"] == got["ints"]
        assert got["f32_hex"] == got["host_f32_hex"] == want_f.tobytes().hex()


def test_choose_route_on_fabricated_identities():
    assert t_dist.choose_route(["GPU-a", "GPU-b", "GPU-c"]) == "device"
    assert t_dist.choose_route(["GPU-a"]) == "device"
    assert t_dist.choose_route(["GPU-a", "GPU-a"]) == "host"
    assert t_dist.choose_route(["GPU-a", "GPU-b", "GPU-a"]) == "host"
    assert t_dist.choose_route(["GPU-a", "none"]) == "host"
    assert t_dist.choose_route(["none", "none"]) == "host"


def test_device_payloads_and_single_host(monkeypatch):
    """float64 payloads keep the host route (psum_hosts_device refuses
    them); one host never sets LAST_PSUM_PATH; a CPU run's card identity
    is "none" without asking CUDA anything."""
    ctx = t_dist.DistContext()
    t_dist.LAST_PSUM_PATH["path"] = None
    a = np.ones(3)
    assert t_dist.psum_hosts(ctx, a)[0] is a
    assert t_dist.LAST_PSUM_PATH["path"] is None
    assert t_dist.DistContext(2, 0, route="device") == \
        t_dist.DistContext(2, 0, "device", group=object())
    assert t_dist._device_payload(np.ones(2, np.int64))
    assert t_dist._device_payload(np.ones(2, np.float32))
    assert not t_dist._device_payload(a)
    with pytest.raises(TypeError, match="float64"):
        t_dist.psum_hosts_device(ctx, a)
    def no_cuda(*args):
        raise AssertionError("a CPU run asked CUDA")
    monkeypatch.setattr(torch.cuda, "get_device_properties", no_cuda)
    monkeypatch.setattr(torch.cuda, "current_device", no_cuda)
    assert t_dist.card_identity(torch.device("cpu")) == "none"
