"""The port's parallel/distributed.py, and the pod mode of its resident
cache, across processes: held against the JAX package's functions on the
8 forced host devices (tests/conftest.py) and against the numpy oracle.

Each case spawns 2 or 4 CPU ranks (this file run as a script, `--worker`)
that join one gloo group and run, on a (2, 1) or (2, 2) mesh over their
global devices: distributed_apply_matrix, shard_parallel_apply,
distributed_encode_blockdiag, distributed_degraded_read and
staged_apply_matrix (each rank staging only its own rows and columns),
then a pod DeviceShardCache (`global_mesh=True`: one lane a rank) that
lane-shards a volume, reads needles through every rank's lane and the
rows' all_gather, and scrubs it.  Every rank writes what it got; the test
holds each byte-equal to the single-process references (the reference's
own multi-process tests fail in every run, so they are no oracle).  Each
rank has its own timeout: a hung rank fails its case and cannot stall
the suite.
"""
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 60
B = 64 * 1024
REQS = [(5, 1000), (B - 700, 700), (1300, 2048), (0, 1), (40_000, 9000)]
PRESENT = [i for i in range(14) if i not in (3, 11)]
NEEDLES = [(3, 0, 1), (3, 100_000, 70_000), (11, 262_000, 144),
           (3, 70_000, 65_536)]


def _inputs():
    """The seeded input every rank and the references share: data [10, B],
    its RS(10,4) parity, and a 256 KB-shard volume for the pod cache."""
    from seaweedfs_tpu_torch.ops import gf256, rs_cpu

    rng = np.random.default_rng(2026)
    data = rng.integers(0, 256, size=(10, B), dtype=np.uint8)
    parity_m = gf256.parity_matrix(10, 14)
    full = np.concatenate([data, rs_cpu.apply_matrix_numpy(parity_m, data)])
    vol = rng.integers(0, 256, size=(10, 256 * 1024), dtype=np.uint8)
    vol = np.concatenate([vol, rs_cpu.apply_matrix_numpy(parity_m, vol)])
    return data, parity_m, full, vol


def _mesh_shape(nproc: int) -> tuple[int, int]:
    return (2, nproc // 2)


def _worker(argv) -> None:
    """One rank: join the gloo group, run every entry point, pickle the
    results to <out>/rank<pid>.pkl."""
    import argparse

    import torch

    from seaweedfs_tpu_torch.ops import rs_resident
    from seaweedfs_tpu_torch.parallel import distributed as dist_mod
    from seaweedfs_tpu_torch.parallel import mesh as mesh_mod

    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", required=True)
    p.add_argument("--nproc", type=int, required=True)
    p.add_argument("--pid", type=int, required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    mesh_mod.initialize_distributed(args.coordinator, args.pid, args.nproc,
                                    backend="gloo")
    try:
        data, parity_m, full, vol = _inputs()
        n_shard, n_batch = _mesh_shape(args.nproc)
        mesh = mesh_mod.make_mesh(n_shard, n_batch,
                                  devices=mesh_mod.global_devices("cpu"))
        got = {"processes": mesh.processes}
        got["apply"] = dist_mod.distributed_apply_matrix(
            mesh, parity_m, data).numpy()
        got["apply_np"] = dist_mod.shard_parallel_apply(mesh, parity_m, data)
        got["blockdiag"] = dist_mod.distributed_encode_blockdiag(
            mesh, parity_m, data)
        got["degraded"] = dist_mod.distributed_degraded_read(
            mesh, full[PRESENT][:10], PRESENT[:10], 3, REQS)
        # this rank's block of the (shard, batch) input
        lane = mesh.local_lanes()[0]
        s, b = divmod(lane, n_batch)
        k_loc, b_loc = 10 // n_shard, B // n_batch
        local = data[s * k_loc : (s + 1) * k_loc, b * b_loc : (b + 1) * b_loc]
        got["staged"] = dist_mod.staged_apply_matrix(mesh, parity_m, local, B)
        # the pod cache: one CPU lane a rank
        cache = rs_resident.DeviceShardCache(
            device="cpu", mesh_devices=0, global_mesh=True,
            mesh_min_shard_bytes=0, shard_quantum=1 << 20)
        got["pod"] = (cache.n_devices, cache.n_hosts, cache.multiprocess)
        for sid in range(14):
            if sid not in (3, 11):
                cache.put(7, sid, vol[sid])
        got["pod_place"] = cache.placement(7)
        got["pod_reads"] = rs_resident.reconstruct_intervals(
            cache, 7, NEEDLES)
        got["pod_dev_bytes"] = list(cache._dev_bytes)
        whole = rs_resident.DeviceShardCache(
            device="cpu", mesh_devices=0, global_mesh=True,
            shard_quantum=1 << 20)
        for sid in range(14):
            whole.put(8, sid, vol[sid])
        got["pod_scrub"] = rs_resident.scrub_volume(cache_full(vol), 9)
        got["pod_whole"] = (whole.placement(8),
                            rs_resident.reconstruct_intervals(
                                whole, 8, [(0, 500, 3000)]))
        with open(os.path.join(args.out, f"rank{args.pid}.pkl"), "wb") as f:
            pickle.dump(got, f)
        print(f"rank {args.pid}: ok")
    finally:
        torch.distributed.destroy_process_group()


def cache_full(vol):
    """A pod cache holding all 14 shards of `vol` as vid 9 (the scrub's
    input), with parity shard 12's byte 70,001 flipped."""
    from seaweedfs_tpu_torch.ops import rs_resident

    bad = vol.copy()
    bad[12, 70_001] ^= 0x5A
    c = rs_resident.DeviceShardCache(
        device="cpu", mesh_devices=0, global_mesh=True,
        mesh_min_shard_bytes=0, shard_quantum=1 << 20)
    for sid in range(14):
        c.put(9, sid, bad[sid])
    return c


def _spawn(nproc: int, tmp_path) -> list[dict]:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = REPO
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker",
             "--coordinator", f"127.0.0.1:{port}", "--nproc", str(nproc),
             "--pid", str(pid), "--out", str(tmp_path)],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)
        for pid in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            try:
                out, _ = p.communicate(timeout=RANK_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                out = b"[killed after its timeout]\n" + out
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"rank {pid}: ok" in out, (
            f"rank {pid} failed:\n{out}")
    results = []
    for pid in range(nproc):
        with open(tmp_path / f"rank{pid}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


@pytest.mark.parametrize("nproc", [2, 4])
def test_distributed_entry_points_across_ranks_match_the_reference(
        nproc, tmp_path):
    import jax

    from seaweedfs_tpu.ops import rs_resident as jax_rr
    from seaweedfs_tpu.parallel import distributed as jax_dist

    data, parity_m, full, vol = _inputs()
    n_shard, n_batch = _mesh_shape(nproc)
    jmesh = jax_dist.make_mesh(n_shard, n_batch,
                               devices=jax.devices("cpu")[:nproc])
    want = {
        "apply": np.asarray(jax_dist.distributed_apply_matrix(
            jmesh, parity_m, data)),
        "blockdiag": np.asarray(jax_dist.distributed_encode_blockdiag(
            jmesh, parity_m, data)),
        "degraded": jax_dist.distributed_degraded_read(
            jmesh, full[PRESENT][:10], PRESENT[:10], 3, REQS),
    }
    np.testing.assert_array_equal(want["apply"], full[10:])
    np.testing.assert_array_equal(want["blockdiag"], full[10:])
    assert want["degraded"] == [full[3][o : o + n].tobytes()
                                for o, n in REQS]
    # the reference's one-process resident read of the same volume
    jc = jax_rr.DeviceShardCache(mesh_devices=nproc, mesh_min_shard_bytes=0,
                                 shard_quantum=1 << 20)
    jc.warm_sizes = ()
    for sid in range(14):
        if sid not in (3, 11):
            jc.put(7, sid, vol[sid])
    want_reads = jax_rr.reconstruct_intervals(jc, 7, NEEDLES)
    assert want_reads == [vol[s][o : o + n].tobytes() for s, o, n in NEEDLES]

    ranks = _spawn(nproc, tmp_path)
    for rank, got in enumerate(ranks):
        assert got["processes"] == sorted(range(nproc))
        for key in ("apply", "apply_np", "blockdiag", "staged"):
            np.testing.assert_array_equal(
                got[key], want["apply"], err_msg=f"rank {rank} {key}")
        assert got["degraded"] == want["degraded"], rank
        assert got["pod"] == (nproc, nproc, True)
        assert got["pod_place"] == "mesh"
        assert got["pod_reads"] == want_reads, rank
        assert got["pod_dev_bytes"] == list(jc._dev_bytes), rank
        assert got["pod_scrub"] == ([0, 0, 1, 0], 3 << 20), rank
        # a whole pin lands on the rank's own lane and reads locally
        assert got["pod_whole"] == (rank, [vol[0][500:3500].tobytes()])


def test_staged_worker_runs_as_users_start_it(tmp_path):
    """`python -m seaweedfs_tpu_torch.parallel.distributed --staged-worker`
    on two CPU ranks: each stages its half and checks the encode."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch.parallel.distributed",
         "--staged-worker", "--coordinator", f"127.0.0.1:{port}",
         "--nproc", "2", "--pid", str(pid), "--device", "cpu"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            try:
                out, _ = p.communicate(timeout=RANK_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"staged worker {pid}: ok" in out, out


def test_one_process_entry_points_match_the_reference():
    """The same entry points in one process over CPU lanes (widths 1-10,
    both axes), byte-equal to the reference on the host devices, with the
    reference's divisibility errors."""
    import jax
    import torch

    from seaweedfs_tpu.parallel import distributed as jax_dist
    from seaweedfs_tpu_torch.parallel import distributed as dist_mod
    from seaweedfs_tpu_torch.parallel import mesh as mesh_mod

    data, parity_m, full, _ = _inputs()
    cpu = [torch.device("cpu")] * 8
    for shape in ((1, 1), (2, 1), (5, 1), (2, 4), (1, 8), (2, 2)):
        mesh = mesh_mod.make_mesh(*shape, devices=cpu)
        jmesh = jax_dist.make_mesh(*shape, devices=jax.devices("cpu"))
        got = dist_mod.shard_parallel_apply(mesh, parity_m, data)
        np.testing.assert_array_equal(
            got, np.asarray(jax_dist.shard_parallel_apply(
                jmesh, parity_m, data)), err_msg=str(shape))
        np.testing.assert_array_equal(got, full[10:])
    np.testing.assert_array_equal(
        dist_mod.split_matrix_bitmajor(parity_m, 5),
        np.asarray(jax_dist.split_matrix_bitmajor(parity_m, 5)))
    mesh = mesh_mod.make_mesh(2, 2, devices=cpu)
    assert dist_mod.distributed_degraded_read(
        mesh, full[PRESENT][:10], PRESENT[:10], 3, REQS) == [
        full[3][o : o + n].tobytes() for o, n in REQS]
    timing = {}
    dist_mod.distributed_apply_matrix(mesh, parity_m, data, timing=timing)
    assert set(timing) == {"k1_s", "collective_s", "fold_s"}
    with pytest.raises(ValueError, match="divisible"):
        dist_mod.distributed_apply_matrix(
            mesh_mod.make_mesh(4, 1, devices=cpu), parity_m, data)
    with pytest.raises(ValueError, match="divisible"):
        dist_mod.distributed_apply_matrix(
            mesh_mod.make_mesh(2, 3, devices=cpu), parity_m, data)
    with pytest.raises(ValueError):
        jax_dist.split_matrix_bitmajor(parity_m, 4)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2:])
