"""The port's CUDA kernels on the card: gf2_matmul, fused_reconstruct and
fused_reconstruct_blockdiag against their plain PyTorch versions and the
numpy oracle, byte for byte, and the EC entry points and the resident
degraded-read path through them.

Every test here needs an NVIDIA GPU with nvcc and skips without one.  The
file imports nothing of JAX, so it also runs on a machine that has only
the port; there the JAX-forcing tests/conftest.py cannot load:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import os
import shutil

import numpy as np
import pytest
import torch

from seaweedfs_tpu_torch.ops import gf256, rs_cpu, rs_cuda, rs_resident
from seaweedfs_tpu_torch.ops.rs import RSCodec
from seaweedfs_tpu_torch.storage import ec
from seaweedfs_tpu_torch.storage.volume import Volume


def _rand(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "k,m,b",
    [(10, 4, 4 * 1024 * 1024 + 37), (10, 1, 4096), (16, 14, 65537),
     (40, 16, 1 << 20), (64, 56, 3001), (1, 1, 1), (10, 4, 4098),
     (13, 3, 4099), (7, 5, 3),
     # k_pad 48 and 64, B % 16 != 0, one output row, small and large
     (48, 4, 4096 + 5), (33, 12, 1 << 16), (64, 16, 1 << 20), (64, 1, 1023),
     (10, 1, 1 << 20), (10, 1, (1 << 16) + 13), (17, 2, 1025), (10, 4, 511)],
)
def test_gf2_matmul_matches_plain(cuda_device, k, m, b):
    mat = _rand((m, k), k + m)
    a = rs_cuda.prepare_matrix(mat, device=cuda_device)
    x = torch.from_numpy(_rand((k, b), b)).to(cuda_device)
    before = rs_cuda.gf2_matmul.launches
    got = rs_cuda.gf2_matmul(a, x, m)
    torch.cuda.synchronize()
    assert rs_cuda.gf2_matmul.launches == before + 1
    assert torch.equal(got, rs_cuda._apply_torch(a, x, m))
    sample = x[:, :4096].cpu().numpy()
    assert np.array_equal(
        got[:, :4096].cpu().numpy(), rs_cpu.apply_matrix_numpy(mat, sample)
    )


@pytest.mark.parametrize("shift", range(1, 16))
def test_gf2_matmul_unaligned_views(cuda_device, shift):
    """Row starts off a 16-byte boundary take the kernel's shifted path
    (aligned chunks realigned in shared memory); the end of the buffer is
    the last row's ragged end.  Rows of 4096 bytes all share the view's
    offset, rows of 5001 and 1 MiB + 5 bytes each have their own."""
    mat = gf256.parity_matrix(10, 14)
    a = rs_cuda.prepare_matrix(mat, device=cuda_device)
    for b in (5001, 4096, (1 << 20) + 5):
        buf = torch.from_numpy(_rand((10 * b + shift,), 5)).to(cuda_device)
        x = buf[shift:].view(10, b)
        assert x.data_ptr() % 16
        before = rs_cuda.gf2_matmul.launches_by_path["shifted"]
        for m in (4, 1):
            assert torch.equal(rs_cuda.gf2_matmul(a, x, m),
                               rs_cuda._apply_torch(a, x, m))
        assert rs_cuda.gf2_matmul.launches_by_path["shifted"] == before + 2


def test_gf2_matmul_load_paths_counted(cuda_device):
    """An aligned call counts on the aligned path, a B % 16 != 0 call on
    the shifted path, and nothing else moves."""
    a = rs_cuda.prepare_matrix(gf256.parity_matrix(10, 14), device=cuda_device)
    for b, path in ((4096, "aligned"), (4096 + 3, "shifted"), (1 << 20, "aligned")):
        x = torch.from_numpy(_rand((10, b), b)).to(cuda_device)
        before = dict(rs_cuda.gf2_matmul.launches_by_path)
        rs_cuda.gf2_matmul(a, x, 4)
        after = rs_cuda.gf2_matmul.launches_by_path
        assert {p: after[p] - before[p] for p in after} == {
            p: int(p == path) for p in after}


def test_gf2_matmul_blockdiag_system(cuda_device):
    """The g=4 block-diagonal system A[128, 384] at x[40, 1 MiB], whose
    all-zero K steps the kernel skips."""
    mat = gf256.parity_matrix(10, 14)
    a = rs_cuda.prepare_matrix_blockdiag(mat, device=cuda_device)
    assert tuple(a.shape) == (128, 384)
    x = torch.from_numpy(_rand((40, 1 << 20), 8)).to(cuda_device)
    got = rs_cuda.gf2_matmul(a, x, 16)
    assert torch.equal(got, rs_cuda._apply_torch(a, x, 16))
    sample = x[:, :4096].cpu().numpy()
    assert np.array_equal(
        got[:, :4096].cpu().numpy(),
        rs_cpu.apply_matrix_numpy(rs_cuda.blockdiag_system(mat), sample))


@pytest.mark.parametrize("k_pad,m_pad", [(16, 4), (32, 8), (48, 4), (64, 16)])
def test_gf2_matmul_largest_counts(cuda_device, k_pad, m_pad):
    """All-ones data and matrix: every count is its largest (8 * k_pad),
    so no byte of the kernel's pack may carry into the next."""
    a = torch.ones((8 * m_pad, 8 * k_pad), dtype=torch.int8, device=cuda_device)
    x = torch.full((k_pad, 4099), 255, dtype=torch.uint8, device=cuda_device)
    for m in (1, 3, m_pad):
        assert torch.equal(rs_cuda.gf2_matmul(a, x, m), rs_cuda._apply_torch(a, x, m))


@pytest.mark.parametrize("k,m,b", [(10, 1, 4096), (10, 1, 1 << 16), (10, 4, 1000),
                                   (16, 14, 3001), (64, 9, 65539), (1, 1, 1)])
def test_gf2_matmul_small_matches_plain(cuda_device, k, m, b):
    """The CUDA-core kernel for small one-row calls takes every argument
    the tensor-core kernel takes."""
    mat = _rand((m, k), k * m + b)
    a = rs_cuda.prepare_matrix(mat, device=cuda_device)
    x = torch.from_numpy(_rand((k, b), b + 1)).to(cuda_device)
    before = rs_cuda.gf2_matmul_small.launches
    got = rs_cuda.gf2_matmul_small(a, x, m)
    torch.cuda.synchronize()
    assert rs_cuda.gf2_matmul_small.launches == before + 1
    assert torch.equal(got, rs_cuda._apply_torch(a, x, m))


def test_small_one_row_calls_take_the_small_kernel(cuda_device):
    """apply_matrix routes one-row calls on aligned rows up to
    SMALL_ONE_ROW_BYTES to gf2_matmul_small and the rest to the tensor
    cores; both give the oracle's bytes."""
    recon1, _ = gf256.reconstruction_matrix(
        10, 14, [i for i in range(14) if i not in (0, 11)], [0])
    parity = gf256.parity_matrix(10, 14)
    for mat, b, small in ((recon1, 4096, True), (recon1, rs_cuda.SMALL_ONE_ROW_BYTES, True),
                          (recon1, 4096 + 3, False), (recon1, 1 << 20, False),
                          (parity, 4096, False)):
        x = _rand((10, b), b)
        n0 = (rs_cuda.gf2_matmul.launches, rs_cuda.gf2_matmul_small.launches)
        got = rs_cuda.apply_matrix(mat, x)
        n1 = (rs_cuda.gf2_matmul.launches, rs_cuda.gf2_matmul_small.launches)
        assert (n1[0] - n0[0], n1[1] - n0[1]) == ((0, 1) if small else (1, 0)), b
        assert np.array_equal(got, rs_cpu.apply_matrix_numpy(mat, x))


def test_gf2_matmul_refuses_bad_arguments(cuda_device):
    a = rs_cuda.prepare_matrix(gf256.parity_matrix(10, 14), device=cuda_device)
    x = torch.zeros((10, 64), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):
        rs_cuda.gf2_matmul(a, x.cpu(), 4)
    with pytest.raises(TypeError):
        rs_cuda.gf2_matmul(a, x.to(torch.int32), 4)
    with pytest.raises(ValueError):
        rs_cuda.gf2_matmul(a, x[:, ::2], 4)
    with pytest.raises(ValueError):
        rs_cuda.gf2_matmul(a, x, 5)
    big = rs_cuda.prepare_matrix(_rand((4, 80), 6), device=cuda_device)  # k_pad 80
    with pytest.raises(RuntimeError, match="k_pad"):
        rs_cuda.gf2_matmul(big, torch.zeros((80, 64), dtype=torch.uint8,
                                            device=cuda_device), 4)


def test_codec_on_card_matches_oracle(cuda_device):
    data = _rand((10, 100_003), 7)
    codec = RSCodec()
    assert codec.backend == "cuda"
    full = codec.encode_all(data)
    assert np.array_equal(full, RSCodec(backend="numpy").encode_all(data))
    got = codec.reconstruct({i: full[i] for i in (1, 2, 3, 4, 6, 7, 8, 9, 11, 12)})
    for i in (0, 5, 10, 13):
        assert np.array_equal(got[i], full[i])
    mat = gf256.parity_matrix(10, 14)
    assert np.array_equal(
        rs_cuda.apply_matrix_blockdiag(mat, data[:, :100_000]),
        rs_cpu.apply_matrix_numpy(mat, data[:, :100_000]),
    )


def test_ec_pipeline_on_card_matches_plain(cuda_device, tmp_path):
    """Encode, verify, degraded read, rebuild on the card equal the plain
    version's files byte for byte, and each launches the kernel."""
    (tmp_path / "cuda").mkdir()
    v = Volume(str(tmp_path / "cuda"), 1)
    for i in range(1, 40):
        v.write(i, i, np.random.default_rng(i).bytes(1000 * i))
    v.close()
    # the same .dat/.idx for both (a write stamps the time into the record)
    shutil.copytree(tmp_path / "cuda", tmp_path / "torch")
    dirs = {b: str(tmp_path / b / "1") for b in ("cuda", "torch")}
    before = rs_cuda.gf2_matmul.launches
    for backend, base in dirs.items():
        ec.write_ec_files(base, backend=backend)
        ec.write_sorted_file_from_idx(base)
    for i in range(14):
        with open(dirs["cuda"] + ec.to_ext(i), "rb") as f1, \
                open(dirs["torch"] + ec.to_ext(i), "rb") as f2:
            assert f1.read() == f2.read(), i
    assert ec.verify_ec_files(dirs["cuda"])[0] == [0, 0, 0, 0]
    ev = ec.EcVolume(str(tmp_path / "cuda"), 1)
    try:
        for sid in range(14):
            if sid not in (0, 11):  # the whole volume lives on shard 0
                ev.add_shard(sid)
        for i in range(1, 40):
            n = ev.read_needle(i, cookie=i)
            assert n.data == np.random.default_rng(i).bytes(1000 * i)
    finally:
        ev.close()
    for i in (0, 5, 10, 13):
        os.remove(dirs["cuda"] + ec.to_ext(i))
    assert ec.rebuild_ec_files(dirs["cuda"]) == [0, 5, 10, 13]
    for i in (0, 5, 10, 13):
        with open(dirs["cuda"] + ec.to_ext(i), "rb") as f1, \
                open(dirs["torch"] + ec.to_ext(i), "rb") as f2:
            assert f1.read() == f2.read(), i
    assert rs_cuda.gf2_matmul.launches > before


# --- the fused reconstruct kernels ---------------------------------------------


def _recon_system(w):
    wanted = [0, 11, 5, 13][:w]
    present = [i for i in range(14) if i not in wanted]
    return gf256.reconstruction_matrix(10, 14, present, wanted)[0]


def _recon_inputs(dev, n, fetch, w, length=8 << 20, seed=0):
    rng = np.random.default_rng(seed)
    surv = tuple(torch.from_numpy(_rand((length,), seed + i)).to(dev)
                 for i in range(10))
    last = (length - fetch) // 1024
    units = rng.integers(0, last + 1, n)
    units[-1] = last
    meta = ((units << 5) | rng.integers(0, w, n)).astype(np.int32)
    return surv, torch.from_numpy(meta)


@pytest.mark.parametrize("layout", ["flat", "blockdiag"])
@pytest.mark.parametrize("n,fetch,w", [
    (1, 6144, 1), (64, 6144, 2), (256, 2048, 2), (16, 3 << 19, 2),
    (8, 2 << 20, 4), (13, 8192, 3),
])
def test_fused_kernels_match_plain(cuda_device, layout, n, fetch, w):
    if layout == "blockdiag":
        fetch, tile = rs_resident._blockdiag_fetch_tile(fetch, 4)
    surv, meta = _recon_inputs(cuda_device, n, fetch, w, seed=n + w)
    mat = _recon_system(w)
    if layout == "flat":
        a = rs_cuda.prepare_matrix(mat, cuda_device)
        fn, kw = rs_resident.fused_reconstruct, dict(w_true=w)
        tile = rs_resident._fused_tile_for(fetch)
        plain = rs_resident._fused_reconstruct_torch
        pkw = {}
    else:
        a = rs_cuda.prepare_matrix_blockdiag(mat, 4, cuda_device)
        fn, kw = rs_resident.fused_reconstruct_blockdiag, dict(w_true=w, groups=4)
        plain = rs_resident._fused_reconstruct_blockdiag_torch
        pkw = kw
    before = fn.launches
    got = fn(a, surv, meta, tile=tile, fetch=fetch, k_true=10, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = plain(a, surv, meta.to(cuda_device), tile=tile, fetch=fetch,
                 k_true=10, **pkw)
    assert torch.equal(got, want)
    # a sample against the numpy table oracle
    j = n - 1
    start = int(meta[j]) >> 5 << 10
    row = int(meta[j]) & 31
    x = np.stack([s[start : start + 4096].cpu().numpy() for s in surv])
    assert np.array_equal(got[j, :4096].cpu().numpy(),
                          rs_cpu.apply_matrix_numpy(mat[row : row + 1], x)[0])


def test_fused_kernels_refuse_bad_arguments(cuda_device):
    surv, meta = _recon_inputs(cuda_device, 4, 2048, 2, length=1 << 20)
    a = rs_cuda.prepare_matrix(_recon_system(2), cuda_device)
    kw = dict(tile=2048, fetch=2048, k_true=10, w_true=2)
    before = rs_resident.fused_reconstruct.launches
    past = torch.tensor([(((1 << 20) - 2048) // 1024 + 1) << 5], dtype=torch.int32)
    with pytest.raises(ValueError, match="runs past"):
        rs_resident.fused_reconstruct(a, surv, past, **kw)
    with pytest.raises(ValueError, match="row"):
        rs_resident.fused_reconstruct(
            a, surv, torch.tensor([2], dtype=torch.int32), **kw)
    with pytest.raises(ValueError, match="survivors"):
        rs_resident.fused_reconstruct(a, surv[:9], meta, **kw)
    with pytest.raises(TypeError):
        rs_resident.fused_reconstruct(a, surv, meta.float(), **kw)
    with pytest.raises(TypeError):
        rs_resident.fused_reconstruct(
            a, tuple(s.to(torch.int16) for s in surv), meta, **kw)
    with pytest.raises(ValueError):
        rs_resident.fused_reconstruct(a.cpu(), surv, meta, **kw)
    # a buffer of the same length off its 16-byte alignment
    big = torch.empty(surv[0].numel() + 1, dtype=torch.uint8, device=cuda_device)
    big[1:].copy_(surv[0])
    shifted = (big[1:],) + surv[1:]
    with pytest.raises(ValueError, match="aligned"):
        rs_resident.fused_reconstruct(a, shifted, meta, **kw)
    assert rs_resident.fused_reconstruct.launches == before


@pytest.mark.parametrize("layout", ["flat", "blockdiag"])
def test_resident_reads_on_card(cuda_device, layout):
    data = _rand((10, 3 << 20), 21)
    shards = RSCodec(backend="numpy").encode_all(data)
    cache = rs_resident.DeviceShardCache(shard_quantum=1 << 22, layout=layout)
    for sid in range(14):
        if sid not in (0, 11):
            cache.put(5, sid, shards[sid])
    length = shards.shape[1]
    rng = np.random.default_rng(4)
    reqs = [(0, 5, 100), (11, 131, 40000), (0, length - 1000, 1000),
            (0, 17, (2 << 20) + 12345)] + [
        (int(rng.choice([0, 11])), int(rng.integers(0, length - 4096)), 4096)
        for _ in range(300)]
    before = (rs_resident.fused_reconstruct.launches
              + rs_resident.fused_reconstruct_blockdiag.launches)
    got = rs_resident.reconstruct_intervals(cache, 5, reqs)
    for (sid, off, size), g in zip(reqs, got):
        assert g == shards[sid][off : off + size].tobytes(), (sid, off, size)
    after = (rs_resident.fused_reconstruct.launches
             + rs_resident.fused_reconstruct_blockdiag.launches)
    assert after > before
    assert cache.pipeline.d2h_bytes > 0 and cache.pipeline.h2d_bytes > 0


def test_ec_volume_resident_on_card(cuda_device, tmp_path):
    v = Volume(str(tmp_path), 1)
    for i in range(1, 40):
        v.write(i, i, np.random.default_rng(i).bytes(1000 * i))
    v.close()
    base = str(tmp_path / "1")
    ec.write_ec_files(base)
    ec.write_sorted_file_from_idx(base)
    ev = ec.EcVolume(str(tmp_path), 1)
    cache = rs_resident.DeviceShardCache(shard_quantum=1 << 22,
                                         layout="blockdiag")
    try:
        for sid in range(14):
            if sid not in (0, 11):
                ev.add_shard(sid)
        assert ev.load_shards_to_device(cache) == 12
        host = rs_cuda.gf2_matmul.launches + rs_cuda.gf2_matmul_small.launches
        got = ev.read_needles_batch(list(range(1, 40)))
        for i, n in zip(range(1, 40), got):
            assert n.data == np.random.default_rng(i).bytes(1000 * i)
        assert ev.read_needle(7, cookie=7).data == np.random.default_rng(7).bytes(7000)
        # no host fallback
        assert rs_cuda.gf2_matmul.launches + rs_cuda.gf2_matmul_small.launches == host
    finally:
        ev.close()
    assert cache.shard_ids(1) == []
