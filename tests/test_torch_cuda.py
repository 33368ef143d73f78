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
    # one launch, or one per RAGGED_MAX_BLOCKS work entries (a 4 KiB span
    # each): the 16 x 1.5 MiB and 8 x 2 MiB calls take two
    entries = n * -(-fetch // rs_resident.RAGGED_SPAN)
    assert fn.launches == before + -(-entries // rs_resident.RAGGED_MAX_BLOCKS)
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
    # the 305 sub-requests (the 2 MiB + 12345 one splits in two) make one
    # work list of 1,128 entries in either layout: one ragged launch, inside
    # the RAGGED_MAX_BLOCKS (3,816) parameter cap
    assert after == before + 1
    # the work list and masks crossed in the launch's parameters; the D2H
    # is each sub-request at its own rounded length
    assert cache.pipeline.h2d_bytes > 0
    subs = rs_resident._plan(reqs)
    q = 4096 if layout == "blockdiag" else 1024
    assert cache.pipeline.d2h_bytes == sum(
        -(-(s[1] % 1024 + s[2] + s[3]) // q) * q for s in subs)


def _ragged_inputs(dev, layout, n, w, seed, max_units=600):
    """n requests of random lengths up to max_units KiB (whole tiles
    block-diagonal), windows anywhere in 8 MiB survivors."""
    mat = _recon_system(w)
    if layout == "flat":
        a, groups = rs_cuda.prepare_matrix(mat, dev), 1
    else:
        a, groups = rs_cuda.prepare_matrix_blockdiag(mat, 4, dev), 4
    length = 8 << 20
    rng = np.random.default_rng(seed)
    unit = groups * 1024
    fetches = rng.integers(1, max_units // groups + 1, n) * unit
    units = rng.integers(0, (length - fetches) // 1024 + 1)
    units[-1] = (length - fetches[-1]) // 1024
    words = (units << 5) | rng.integers(0, w, n)
    surv, _ = _recon_inputs(dev, 1, 1024, w, length=length, seed=seed)
    return mat, a, groups, surv, words, fetches


@pytest.mark.parametrize("layout", ["flat", "blockdiag"])
@pytest.mark.parametrize("n,w,max_units", [(1, 1, 4), (7, 2, 9), (64, 2, 200),
                                           (33, 4, 1100)])
def test_ragged_kernel_matches_plain(cuda_device, layout, n, w, max_units):
    """Mixed fetch lengths in one launch, byte-equal to the ragged plain
    version, and the first request to the numpy oracle."""
    mat, a, groups, surv, words, fetches = _ragged_inputs(
        cuda_device, layout, n, w, n + w, max_units)
    fn = (rs_resident.fused_reconstruct if groups == 1
          else rs_resident.fused_reconstruct_blockdiag)
    before = fn.launches
    got, offsets = rs_resident.fused_reconstruct_ragged(
        a, surv, words, fetches, k_true=10, w_true=w, groups=groups)
    torch.cuda.synchronize()
    blocks = int(sum(-(-fetches // rs_resident.RAGGED_SPAN)))
    assert fn.launches == before + -(-blocks // rs_resident.RAGGED_MAX_BLOCKS)
    want = rs_resident._fused_reconstruct_ragged_torch(
        a, surv, words, fetches, k_true=10, w_true=w, groups=groups,
        tile=groups * 1024)
    assert torch.equal(got, want)
    start = int(words[0]) >> 5 << 10
    x = np.stack([s[start : start + 4096].cpu().numpy() for s in surv])
    row = int(words[0]) & 31
    f0 = min(4096, int(fetches[0]))
    assert np.array_equal(got[:f0].cpu().numpy(),
                          rs_cpu.apply_matrix_numpy(mat[row : row + 1], x)[0][:f0])


@pytest.mark.parametrize("layout", ["flat", "blockdiag"])
def test_ragged_list_splits_into_launches(cuda_device, layout):
    """A list longer than one launch's parameters takes more launches, each
    counted, and the same bytes."""
    mat, a, groups, surv, words, fetches = _ragged_inputs(
        cuda_device, layout, 48, 2, 9, max_units=1024)
    blocks = int(sum(-(-fetches // rs_resident.RAGGED_SPAN)))
    assert blocks > rs_resident.RAGGED_MAX_BLOCKS
    fn = (rs_resident.fused_reconstruct if groups == 1
          else rs_resident.fused_reconstruct_blockdiag)
    before = fn.launches
    got, _ = rs_resident.fused_reconstruct_ragged(
        a, surv, words, fetches, k_true=10, w_true=2, groups=groups)
    torch.cuda.synchronize()
    assert fn.launches - before == -(-blocks // rs_resident.RAGGED_MAX_BLOCKS) > 1
    want = rs_resident._fused_reconstruct_ragged_torch(
        a, surv, words, fetches, k_true=10, w_true=2, groups=groups,
        tile=groups * 1024)
    assert torch.equal(got, want)


def test_ragged_kernel_refuses_bad_calls(cuda_device):
    """A window past the survivors, a bad row, a misaligned fetch or
    survivor buffer: refused on the host, no launch counted."""
    mat, a, _, surv, words, fetches = _ragged_inputs(
        cuda_device, "flat", 4, 2, 3, max_units=8)
    kw = dict(k_true=10, w_true=2, groups=1)
    before = (rs_resident.fused_reconstruct.launches,
              rs_resident.fused_reconstruct_blockdiag.launches)
    past = (((8 << 20) - 2048) // 1024 + 1) << 5
    with pytest.raises(ValueError, match="runs past"):
        rs_resident.fused_reconstruct_ragged(a, surv, [0, past], [1024, 2048], **kw)
    with pytest.raises(ValueError, match="row"):
        rs_resident.fused_reconstruct_ragged(a, surv, [0, 2], [1024, 1024], **kw)
    with pytest.raises(ValueError, match="multiple"):
        rs_resident.fused_reconstruct_ragged(a, surv, [0, 32], [1024, 1000], **kw)
    big = torch.empty(surv[0].numel() + 1, dtype=torch.uint8, device=cuda_device)
    big[1:].copy_(surv[0])
    with pytest.raises(ValueError, match="aligned"):
        rs_resident.fused_reconstruct_ragged(a, (big[1:],) + surv[1:], words,
                                             fetches, **kw)
    a_blk = rs_cuda.prepare_matrix_blockdiag(_recon_system(2), 4, cuda_device)
    with pytest.raises(ValueError, match="multiple"):
        rs_resident.fused_reconstruct_ragged(a_blk, surv, [0], [2048], k_true=10,
                                             w_true=2, groups=4)
    assert (rs_resident.fused_reconstruct.launches,
            rs_resident.fused_reconstruct_blockdiag.launches) == before


@pytest.mark.parametrize("groups,n,max_units", [(1, 5, 9), (4, 40, 1024),
                                                 (1, 3000, 3)])
def test_kernel_work_list_is_the_host_model(cuda_device, groups, n, max_units):
    """The launch entry's work list (span, capacity, entries, the split into
    launches) is rs_resident's model of it, which the CPU tests hold."""
    import ctypes

    from seaweedfs_tpu_torch.ops import _build

    lib = _build.kernels()
    span, blocks = ctypes.c_int(), ctypes.c_int()
    lib.fused_reconstruct_limits(ctypes.byref(span), ctypes.byref(blocks))
    assert (span.value, blocks.value) == (rs_resident.RAGGED_SPAN,
                                          rs_resident.RAGGED_MAX_BLOCKS)
    rng = np.random.default_rng(n)
    tile = groups * 1024
    fetches = rng.integers(1, max_units + 1, n) * tile
    words = ((rng.integers(0, 1 << 20, n) << 5) | rng.integers(0, 4, n))
    want = np.concatenate([w for _, w in rs_resident._launch_lists(
        rs_resident._work_list(words, fetches, groups, tile))])
    w32 = words.astype(np.int32)
    fk = (fetches // 1024).astype(np.int32)
    got = np.zeros_like(want)
    total = lib.fused_reconstruct_work_list(
        w32.ctypes.data, fk.ctypes.data, n, groups, tile, got.ctypes.data,
        len(got))
    assert total == len(want)
    assert np.array_equal(got, want)


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


# --- the volume server on the card ---------------------------------------


@pytest.mark.parametrize("layout", ["flat", "blockdiag"])
def test_volume_server_serves_from_the_card(cuda_device, tmp_path, layout):
    """The HTTP server over a degraded EC volume (shards 0 and 11 gone)
    pinned on the card: concurrent reads are byte-equal, every read after
    the pin routes `batched` (no host K1 launch), the fused kernel launches
    at most once a batch (a batch here never outgrows one launch's work
    list or its 32 MiB output), and the pipeline has the configured
    slots."""
    import asyncio
    import json

    from seaweedfs_tpu_torch import stats
    from seaweedfs_tpu_torch.server.http import Client
    from seaweedfs_tpu_torch.server.volume import VolumeServer
    from seaweedfs_tpu_torch.serving import ServingConfig
    from seaweedfs_tpu_torch.storage import types as t

    rng = np.random.default_rng(17)
    items = [(i, int(rng.integers(0, 1 << 32)),
              rng.bytes(int(rng.choice([100, 5000, 70000, 120000]))))
             for i in range(1, 41)]
    v = Volume(str(tmp_path), 1)
    for nid, cookie, data in items:
        v.write(nid, cookie, data)
    v.close()
    base = str(tmp_path / "1")
    ec.write_ec_files(base)
    ec.write_sorted_file_from_idx(base)
    for ext in (".dat", ".idx", ec.to_ext(0), ec.to_ext(11)):
        os.remove(base + ext)
    kern = (rs_resident.fused_reconstruct_blockdiag if layout == "blockdiag"
            else rs_resident.fused_reconstruct)
    route = stats.VOLUME_SERVER_EC_READ_ROUTE

    async def go():
        vs = VolumeServer([], [str(tmp_path)], port=0, ec_backend="cuda",
                          ec_device_cache_mb=2048,
                          ec_serving=ServingConfig(layout=layout))
        await vs.start()
        try:
            cache = vs.store.ec_device_cache
            assert cache.device.type == "cuda" and cache.layout == layout
            assert cache.pipeline.slots == vs.ec_serving.pipeline_slots == 2
            c = Client("127.0.0.1", vs.port)
            for _ in range(600):
                st = json.loads((await c.request("GET", "/status"))[2])
                if st["EcVolumes"][0]["serving"] and \
                        len(st["EcVolumes"][0]["resident"]) == 12:
                    break
                await asyncio.sleep(0.05)
            await c.close()
            assert vs.store.ec_volume_is_resident(1)
            l0, b0 = kern.launches, stats.VOLUME_SERVER_EC_BATCH_SIZE.count
            k0 = rs_cuda.gf2_matmul.launches + rs_cuda.gf2_matmul_small.launches
            r0 = {r: route.labels(route=r).value for r in ("batched", "native")}

            async def client(i):
                cl = Client("127.0.0.1", vs.port)
                try:
                    for k in range(i, i + 20):
                        nid, cookie, data = items[k % len(items)]
                        status, _, body = await cl.request(
                            "GET", "/" + t.format_fid(1, nid, cookie))
                        assert (status, body) == (200, data), nid
                finally:
                    await cl.close()

            await asyncio.gather(*(client(i) for i in range(16)))
            batches = stats.VOLUME_SERVER_EC_BATCH_SIZE.count - b0
            launches = kern.launches - l0
            routes = {r: route.labels(route=r).value - r0[r]
                      for r in ("batched", "native")}
            assert routes == {"batched": 16 * 20, "native": 0}
            assert 0 < launches <= batches < 16 * 20
            assert rs_cuda.gf2_matmul.launches + \
                rs_cuda.gf2_matmul_small.launches == k0
        finally:
            await vs.stop()

    asyncio.run(go())


def test_volume_server_cache_follows_overlap(cuda_device, tmp_path):
    from seaweedfs_tpu_torch.server.volume import VolumeServer
    from seaweedfs_tpu_torch.serving import ServingConfig

    vs = VolumeServer([], [str(tmp_path)], port=0, ec_backend="cuda",
                      ec_device_cache_mb=64,
                      ec_serving=ServingConfig(overlap=False))
    try:
        assert vs.store.ec_device_cache.pipeline.slots == 1
        assert vs.store.ec_device_cache.layout == "flat"
    finally:
        vs.store.close()


def test_two_lanes_keep_their_bodies_on_card(cuda_device, tmp_path):
    """Two threads batch-read disjoint needle sets through the Store at
    once, zero-copy, keeping every result until the end: no body is a view
    of a pipeline slot's pinned buffer, which the slot's next batch
    overwrites."""
    import threading

    from seaweedfs_tpu_torch.storage.disk_location import DiskLocation
    from seaweedfs_tpu_torch.storage.store import Store

    rng = np.random.default_rng(23)
    items = [(i, int(rng.integers(0, 1 << 32)),
              rng.bytes(int(rng.choice([100, 5000, 70000, 120000]))))
             for i in range(1, 41)]
    v = Volume(str(tmp_path), 1)
    for nid, cookie, data in items:
        v.write(nid, cookie, data)
    v.close()
    base = str(tmp_path / "1")
    ec.write_ec_files(base)
    ec.write_sorted_file_from_idx(base)
    for ext in (".dat", ".idx", ec.to_ext(0), ec.to_ext(11)):
        os.remove(base + ext)
    cache = rs_resident.DeviceShardCache(shard_quantum=1 << 22)
    store = Store([DiskLocation(str(tmp_path))], ec_device_cache=cache)
    try:
        for _ in range(600):
            if cache.resident_count(1) == 12:
                break
            threading.Event().wait(0.05)
        assert store.ec_volume_is_resident(1)
        halves = (items[0::2], items[1::2])
        kept: list = [[], []]
        errors: list = []

        def lane(i):
            try:
                for _ in range(8):
                    kept[i].append(store.read_ec_needles_batch(
                        1, [(n, c) for n, c, _ in halves[i]], zero_copy=True))
            except Exception as e:  # noqa: BLE001 — asserted below
                errors.append(e)

        threads = [threading.Thread(target=lane, args=(i,)) for i in (0, 1)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
        assert not errors and not any(th.is_alive() for th in threads)
        for i in (0, 1):
            assert len(kept[i]) == 8
            for got in kept[i]:
                assert [bytes(n.data) for n in got] == [d for _, _, d in halves[i]]
    finally:
        store.close()


# --- the parity scrub (csrc/scrub.cu) ---------------------------------------


def _scrub_volumes(n_vols, size, seed, flips=()):
    """n_vols RS(10,4) volumes of `size`-byte shards (numpy, seeded), each
    a [14, size] array; `flips` (volume, shard, byte) XORs 0x5A in."""
    out = []
    for v in range(n_vols):
        data = _rand((10, size), seed + v)
        out.append(RSCodec(backend="numpy").encode_all(data))
    for v, sid, byte in flips:
        out[v][sid, byte] ^= 0x5A
    return out


def _on_card(shards, n_lanes, device):
    """Each shard on the card, zero-padded past n_lanes as the cache pads."""
    pad = n_lanes - shards.shape[1] + 4096
    return tuple(torch.from_numpy(np.pad(s, (0, pad))).to(device)
                 for s in shards)


def _code_volumes(n_vols, size, seed, k, p, flips=(), dense=False):
    """n_vols RS(k, k+p) volumes of `size`-byte shards (numpy, seeded);
    `flips` (volume, shard, byte) XOR 0x5A in; `dense` replaces every
    parity byte with a random one."""
    parity_m = gf256.build_matrix(k, k + p)[k:]
    out = []
    for v in range(n_vols):
        rng = np.random.default_rng(seed + v)
        data = rng.integers(0, 256, (k, size), dtype=np.uint8)
        par = (rng.integers(0, 256, (p, size), dtype=np.uint8) if dense
               else rs_cpu.apply_matrix_numpy(parity_m, data))
        out.append(np.concatenate([data, par]))
    for v, sid, byte in flips:
        out[v][sid, byte] ^= 0x5A
    return out


def _mismatch_oracle(vols, k):
    """numpy: mismatching bytes per volume and parity row, [V, p]."""
    p = vols[0].shape[0] - k
    parity_m = gf256.build_matrix(k, k + p)[k:]
    return np.array([(rs_cpu.apply_matrix_numpy(parity_m, v[:k]) != v[k:])
                     .sum(axis=1) for v in vols])


# (volumes, shard bytes, seg_log2, (k, p), dense parity)
SCRUB_CASES = [
    (1, 300_000, 28, (10, 4), False), (1, 300_000, 12, (10, 4), False),
    (3, (1 << 20) + 37, 13, (10, 4), False), (32, 70_001, 28, (10, 4), False),
    (2, 5 * 65536 + 128, 12, (10, 4), False),
    # every parity byte wrong: the counts, not only sparse flips
    (1, 300_000, 13, (10, 4), True), (4, 70_001, 12, (8, 8), True),
    # n_lanes ends mid-tile; block-diagonal group boundaries mid-tile
    (2, 5 * 4096 + 600, 12, (10, 4), False),
    # other codes, k + p <= 16 slots
    (2, 70_001, 13, (6, 3), False), (2, 70_001, 12, (12, 4), False),
    (2, 70_001, 15, (8, 8), False),
]


@pytest.mark.parametrize("layout", ["flat", "blockdiag"])
@pytest.mark.parametrize("n_vols,size,seg_log2,code,dense", SCRUB_CASES)
def test_scrub_kernel_matches_plain_and_model(cuda_device, layout, n_vols,
                                              size, seg_log2, code, dense):
    k, p = code
    groups = (4 if 4 * p <= 16 else 2) if layout == "blockdiag" else 1
    n_lanes = rs_resident._scrub_span(size, groups * 128)
    flips = [(0, k + 2 if p > 2 else k, 0), (0, k + 2 if p > 2 else k, size - 1),
             (0, 3, size // 2), (n_vols - 1, k, 4096 * 3 + 5),
             (n_vols - 1, 0, 65536 + 17)]
    flips = [f for f in flips if f[2] < size]
    vols = _code_volumes(n_vols, size, seed=size % 97, k=k, p=p, flips=flips,
                         dense=dense)
    a = rs_resident._scrub_matrix(k, k + p, groups, str(cuda_device))
    card = [_on_card(v, n_lanes, cuda_device) for v in vols]
    before = rs_resident.scrub.launches
    got = rs_resident.scrub(a, card, n_lanes=n_lanes, k=k, groups=groups,
                            seg_log2=seg_log2)
    torch.cuda.synchronize()
    assert rs_resident.scrub.launches == before + 1
    assert got.dtype == torch.int32
    assert got.shape == (n_vols, p, rs_resident._scrub_segments(n_lanes, seg_log2))
    plain = rs_resident._scrub_torch(a, card, k=k, n_lanes=n_lanes,
                                     groups=groups, seg_log2=seg_log2)
    assert torch.equal(got, plain)
    if n_vols <= 3:
        host = [tuple(s.cpu().numpy() for s in v) for v in card]
        model, _ = rs_resident._scrub_model(
            rs_resident._scrub_masks(a, k, p, groups), host, k=k,
            n_lanes=n_lanes, groups=groups, seg_log2=seg_log2)
        assert np.array_equal(got.cpu().numpy(), model)
    assert np.array_equal(got.cpu().numpy().sum(-1), _mismatch_oracle(vols, k))


@pytest.mark.parametrize("layout", ["flat", "blockdiag"])
@pytest.mark.parametrize("code,dense", [((10, 4), False), ((10, 4), True),
                                        ((6, 3), False), ((8, 8), True)])
def test_scrub_cuda_cores_variant_equals_kernel(cuda_device, layout, code,
                                                dense):
    """The earlier CUDA-core kernel (timed beside the tensor-core one in
    chip_smoke.py) gives the tensor-core kernel's partials; each counts
    only its own launches."""
    k, p = code
    groups = (4 if 4 * p <= 16 else 2) if layout == "blockdiag" else 1
    size = 3 * 65536 + 1000
    n_lanes = rs_resident._scrub_span(size, groups * 128)
    vols = _code_volumes(3, size, seed=7, k=k, p=p,
                         flips=[(1, k, 5), (2, 1, size - 1)], dense=dense)
    a = rs_resident._scrub_matrix(k, k + p, groups, str(cuda_device))
    card = [_on_card(v, n_lanes, cuda_device) for v in vols]
    tc, cc = rs_resident.scrub.launches, rs_resident.scrub_cuda_cores.launches
    got = rs_resident.scrub(a, card, n_lanes=n_lanes, k=k, groups=groups,
                            seg_log2=12)
    old = rs_resident.scrub_cuda_cores(a, card, n_lanes=n_lanes, k=k,
                                       groups=groups, seg_log2=12)
    torch.cuda.synchronize()
    assert torch.equal(got, old)
    assert (rs_resident.scrub.launches, rs_resident.scrub_cuda_cores.launches) \
        == (tc + 1, cc + 1)
    assert np.array_equal(got.cpu().numpy().sum(-1), _mismatch_oracle(vols, k))


@pytest.mark.parametrize("k,p,groups", [(10, 4, 1), (10, 4, 4), (6, 3, 5),
                                        (8, 8, 2), (12, 4, 4), (1, 1, 8)])
def test_scrub_fragments_equal_the_model(cuda_device, k, p, groups):
    """The C entry's B fragments (scrub_fragments, what scrub_launch puts
    in the kernel's parameters) equal the numpy mirror the model uses, and
    the launch's persistent grid fits at least one block an SM."""
    a = rs_resident._scrub_matrix(k, k + p, groups, str(cuda_device))
    masks = rs_resident._scrub_masks(a, k, p, groups)
    want = rs_resident._scrub_fragments(masks, p, groups)
    out = np.zeros(want.size, dtype=np.uint32)
    lib = rs_resident._scrub_lib()
    assert lib.scrub_fragments(masks.ctypes.data, k, p, groups,
                               out.ctypes.data) == want.size
    assert np.array_equal(out, want.reshape(-1))
    assert lib.scrub_blocks_per_sm(k, p, groups) >= 1


def test_scrub_volume_on_card_equals_cpu(cuda_device):
    """scrub_volume and scrub_all_resident on a CUDA cache give the CPU
    cache's counts and spans, in both layouts, with 16 bytes of partials
    per volume and segment the only D2H."""
    vols = _scrub_volumes(3, 200_003, seed=4, flips=[(1, 11, 7), (2, 5, 99)])
    vols[2] = vols[2][:, :150_000].copy()  # another span class
    for layout in ("flat", "blockdiag"):
        caches = [rs_resident.DeviceShardCache(shard_quantum=1 << 20,
                                               layout=layout, device=d)
                  for d in ("cpu", cuda_device)]
        for cache in caches:
            for vid, shards in enumerate(vols, start=1):
                for sid in range(14):
                    cache.put(vid, sid, shards[sid])
        d2h = rs_resident.scrub.d2h_bytes
        got = [rs_resident.scrub_volume(caches[1], vid) for vid in (1, 2, 3)]
        assert rs_resident.scrub.d2h_bytes == d2h + 3 * 16
        assert got == [rs_resident.scrub_volume(caches[0], vid)
                       for vid in (1, 2, 3)]
        assert [g[0] for g in got] == [[0, 0, 0, 0], [0, 1, 0, 0],
                                       [1, 1, 1, 1]]
        res, st = rs_resident.scrub_all_resident(caches[1])
        assert st == {"device_calls": 2, "volumes": 3}
        assert res == rs_resident.scrub_all_resident(caches[0])[0]
        assert res == {vid: g for vid, g in zip((1, 2, 3), got)}
        for cache in caches:
            cache.clear()


def test_scrub_all_resident_stacks_32_a_launch(cuda_device):
    vols = _scrub_volumes(33, 4096 * 3, seed=9, flips=[(32, 13, 1)])
    cache = rs_resident.DeviceShardCache(shard_quantum=1 << 20,
                                         device=cuda_device)
    for vid, shards in enumerate(vols):
        for sid in range(14):
            cache.put(vid, sid, shards[sid])
    before = rs_resident.scrub.launches
    res, st = rs_resident.scrub_all_resident(cache)
    assert st == {"device_calls": 2, "volumes": 33}
    assert rs_resident.scrub.launches == before + 2
    assert res[32] == ([0, 0, 0, 1], 4096 * 3)
    assert all(res[v] == ([0] * 4, 4096 * 3) for v in range(32))
    # the same 33 volumes straight through the wrapper: 32 a launch, so
    # two launches, each equal to the plain version
    a = rs_resident._scrub_matrix(10, 14, 1, str(cuda_device))
    card = [tuple(cache.get(vid, s) for s in range(14)) for vid in range(33)]
    for chunk in (card[:32], card[32:]):
        got = rs_resident.scrub(a, chunk, n_lanes=4096 * 3, seg_log2=12)
        assert torch.equal(got, rs_resident._scrub_torch(
            a, chunk, k=10, n_lanes=4096 * 3, groups=1, seg_log2=12))
    with pytest.raises(ValueError, match="volumes"):
        rs_resident.scrub(a, card, n_lanes=4096 * 3)


def test_scrub_shard_evicted_mid_scrub(cuda_device):
    """A shard evicted between the listing and the call is a CacheMiss; a
    shard evicted after the call took its buffers is still read whole
    (the buffers outlive the eviction until the kernel is done)."""
    vols = _scrub_volumes(1, 100_000, seed=2, flips=[(0, 13, 5)])
    cache = rs_resident.DeviceShardCache(shard_quantum=1 << 20,
                                         device=cuda_device)
    for sid in range(14):
        cache.put(1, sid, vols[0][sid])
    real = cache._get_ready

    def evicting(vid, sid):
        if sid == 0:
            cache.evict(vid, 13)
        return real(vid, sid)

    cache._get_ready = evicting
    with pytest.raises(rs_resident.CacheMiss, match="evicted"):
        rs_resident.scrub_volume(cache, 1)
    cache._get_ready = real
    cache.put(1, 13, vols[0][13])
    run = rs_resident._scrub_run

    def evict_then_run(c, a, got, *args):
        c.evict(1)
        torch.cuda.empty_cache()
        return run(c, a, got, *args)

    rs_resident._scrub_run = evict_then_run
    try:
        assert rs_resident.scrub_volume(cache, 1) == ([0, 0, 0, 1], 100_096)
    finally:
        rs_resident._scrub_run = run
    assert cache.resident_count(1) == 0


def test_scrub_refuses_bad_arguments(cuda_device):
    vols = _scrub_volumes(1, 8192, seed=1)
    card = [_on_card(vols[0], 8192, cuda_device)]
    a = rs_resident._scrub_matrix(10, 14, 1, str(cuda_device))
    before = rs_resident.scrub.launches
    with pytest.raises(ValueError, match="multiple"):
        rs_resident.scrub(a, card, n_lanes=8192 + 64)
    with pytest.raises(ValueError, match="seg_log2"):
        rs_resident.scrub(a, card, n_lanes=8192, seg_log2=11)
    with pytest.raises(ValueError, match="runs past"):
        rs_resident.scrub(a, card, n_lanes=1 << 20)
    with pytest.raises(ValueError, match="volumes"):
        rs_resident.scrub(a, card * 33, n_lanes=8192)
    big = torch.empty(card[0][0].numel() + 1, dtype=torch.uint8,
                      device=cuda_device)
    shifted = [(big[1:],) + card[0][1:]]
    with pytest.raises(ValueError, match="aligned"):
        rs_resident.scrub(a, shifted, n_lanes=8192)
    with pytest.raises(ValueError):
        rs_resident.scrub(a.cpu(), card, n_lanes=8192)
    assert rs_resident.scrub.launches == before


# --- the observability plane on the card -------------------------------------


@pytest.mark.parametrize("layout", ["flat", "blockdiag"])
def test_traced_resident_call_splits_at_the_kernel(cuda_device, layout,
                                                   monkeypatch):
    """A traced reconstruct_intervals on the card: device_execute holds
    the kernel's CUDA-event time, and d2h_copy opens only after the
    kernel's completion event fired.  A device spin before the launch
    makes the kernel finish ~20 ms after it was enqueued: that wait lands
    in device_execute, never in d2h_copy."""
    from seaweedfs_tpu_torch import obs

    data = _rand((10, 1 << 20), 23)
    shards = RSCodec(backend="numpy").encode_all(data)
    cache = rs_resident.DeviceShardCache(shard_quantum=1 << 22, layout=layout)
    for sid in range(14):
        if sid not in (0, 11):
            cache.put(5, sid, shards[sid])
    reqs = [(0, 4096 * i + 7, 3000) for i in range(64)]
    rs_resident.reconstruct_intervals(cache, 5, reqs)  # warm the slot
    real = rs_resident._dispatch_call
    timed = []
    spin_cycles = 40_000_000  # ~20 ms at the H100's clocks

    def spun(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        start.record()
        out = real(*a, **kw)
        end.record()
        timed.append((start, end))
        return out

    monkeypatch.setattr(rs_resident, "_dispatch_call", spun)
    t, tok = obs.start_trace("GET /5,ab", "volume")
    try:
        got = rs_resident.reconstruct_intervals(cache, 5, reqs)
    finally:
        obs.finish_trace(t, tok, 200)
    for (sid, off, size), g in zip(reqs, got):
        assert g == shards[sid][off : off + size].tobytes()
    assert len(timed) == 1
    kernel_ms = timed[0][0].elapsed_time(timed[0][1])
    spans = {s.name: s for s in t.spans}
    assert [s.name for s in t.spans] == ["batch_pack", "device_execute",
                                         "d2h_copy"]
    dev, d2h = spans["device_execute"], spans["d2h_copy"]
    assert d2h.parent_id == dev.span_id
    assert dev.duration * 1e3 >= kernel_ms
    # d2h_copy starts after the spin and the kernel, inside device_execute
    assert (d2h.start - dev.start) * 1e3 >= kernel_ms
    assert (d2h.start - dev.start) * 1e3 >= 10.0
    assert d2h.duration * 1e3 < 10.0
    assert dev.annotations["kernel"] == (
        "fused_reconstruct_blockdiag" if layout == "blockdiag"
        else "fused_reconstruct")
    assert dev.annotations["d2h_bytes"] == d2h.annotations["bytes"] > 0
    assert dev.annotations["h2d_bytes"] > 0  # the launch's parameters


def test_debug_profile_on_a_live_server_returns_kernel_events(
        cuda_device, tmp_path, monkeypatch):
    """With SWFS_DEBUG=1, /debug/profile?seconds=N captures the live
    server on torch.profiler while clients read: the exported trace holds
    the fused reconstruct kernel's events."""
    import asyncio
    import json

    from seaweedfs_tpu_torch.server.http import Client
    from seaweedfs_tpu_torch.server.volume import VolumeServer
    from seaweedfs_tpu_torch.storage import types as t
    from seaweedfs_tpu_torch.utils import devtime

    monkeypatch.setenv("SWFS_DEBUG", "1")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    rng = np.random.default_rng(29)
    items = [(i, int(rng.integers(0, 1 << 32)), rng.bytes(20000))
             for i in range(1, 41)]
    vdir = tmp_path / "v"
    vdir.mkdir()
    v = Volume(str(vdir), 1)
    for nid, cookie, data in items:
        v.write(nid, cookie, data)
    v.close()
    base = str(vdir / "1")
    ec.write_ec_files(base)
    ec.write_sorted_file_from_idx(base)
    for ext in (".dat", ".idx", ec.to_ext(0), ec.to_ext(11)):
        os.remove(base + ext)

    async def go():
        vs = VolumeServer([], [str(vdir)], port=0, ec_backend="cuda",
                          ec_device_cache_mb=2048)
        await vs.start()
        try:
            c = Client("127.0.0.1", vs.port)
            for _ in range(600):
                st = json.loads((await c.request("GET", "/status"))[2])
                if st["EcVolumes"][0]["serving"]:
                    break
                await asyncio.sleep(0.05)
            stop = asyncio.Event()

            async def reader(i):
                cl = Client("127.0.0.1", vs.port)
                try:
                    k = i
                    while not stop.is_set():
                        nid, cookie, data = items[k % len(items)]
                        status, _, body = await cl.request(
                            "GET", "/" + t.format_fid(1, nid, cookie))
                        assert (status, body) == (200, data)
                        k += 1
                finally:
                    await cl.close()

            readers = [asyncio.ensure_future(reader(i)) for i in range(8)]
            capture = asyncio.ensure_future(
                c.request("GET", "/debug/profile?seconds=2"))
            await asyncio.sleep(0.5)
            c2 = Client("127.0.0.1", vs.port)
            busy = (await c2.request("GET", "/debug/profile?seconds=1"))[0]
            await c2.close()
            status, _, body = await capture
            stop.set()
            await asyncio.gather(*readers)
            await c.close()
            return status, json.loads(body), busy
        finally:
            await vs.stop()

    status, doc, busy = asyncio.run(go())
    assert busy == 409  # single flight
    assert status == 200, doc
    assert set(doc) == {"trace_dir", "seconds", "started_unix_ms",
                        "hot_shapes"}
    events = devtime.kernel_events(os.path.join(doc["trace_dir"],
                                                "trace.json"))
    names = {name for name, _, _ in events}
    assert any("fused_reconstruct" in n for n in names), names
    assert doc["hot_shapes"] and doc["hot_shapes"][0]["dispatches"] > 0


def test_incident_bundle_profiles_a_live_server_on_the_card(
        cuda_device, tmp_path, monkeypatch):
    """The master's incident bundler, fired by hand for a latency SLO
    against an in-process server serving resident reads: the bundle's
    profile is the server's CUPTI capture, with no error, and its trace
    names the fused reconstruct kernel with device time."""
    import asyncio
    import json
    import tempfile

    from seaweedfs_tpu_torch.obs import incident as obs_incident
    from seaweedfs_tpu_torch.server.http import Client
    from seaweedfs_tpu_torch.server.volume import VolumeServer
    from seaweedfs_tpu_torch.storage import types as t
    from seaweedfs_tpu_torch.utils import devtime

    monkeypatch.setenv("SWFS_DEBUG", "1")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)
    monkeypatch.setattr(obs_incident, "CONFIG", obs_incident.IncidentConfig(
        dir=str(tmp_path / "incidents"), min_interval_seconds=0.0,
        profile_seconds=2.0))
    rng = np.random.default_rng(31)
    items = [(i, int(rng.integers(0, 1 << 32)), rng.bytes(30000))
             for i in range(1, 41)]
    vdir = tmp_path / "v"
    vdir.mkdir()
    v = Volume(str(vdir), 1)
    for nid, cookie, data in items:
        v.write(nid, cookie, data)
    v.close()
    base = str(vdir / "1")
    ec.write_ec_files(base)
    ec.write_sorted_file_from_idx(base)
    for ext in (".dat", ".idx", ec.to_ext(0), ec.to_ext(11)):
        os.remove(base + ext)

    async def go():
        vs = VolumeServer([], [str(vdir)], port=0, ec_backend="cuda",
                          ec_device_cache_mb=2048)
        await vs.start()
        try:
            c = Client("127.0.0.1", vs.port)
            for _ in range(600):
                st = json.loads((await c.request("GET", "/status"))[2])
                if st["EcVolumes"][0]["serving"]:
                    break
                await asyncio.sleep(0.05)
            await c.close()
            stop = asyncio.Event()

            async def reader(i):
                cl = Client("127.0.0.1", vs.port)
                try:
                    k = i
                    while not stop.is_set():
                        nid, cookie, data = items[k % len(items)]
                        status, _, body = await cl.request(
                            "GET", "/" + t.format_fid(1, nid, cookie))
                        assert (status, body) == (200, data)
                        k += 1
                finally:
                    await cl.close()

            readers = [asyncio.ensure_future(reader(i)) for i in range(8)]
            bundler = obs_incident.IncidentBundler(
                lambda: [vs.url],
                lambda: {"nodes": {vs.url: {"dispatcher": {
                    "queue_depth": 1}}}})
            await asyncio.sleep(0.5)
            summary = await bundler.capture(
                {"slo": "read_p99", "latency": True}, window_s=30.0)
            stop.set()
            await asyncio.gather(*readers)
            return summary
        finally:
            await vs.stop()

    summary = asyncio.run(go())
    with open(summary["path"]) as f:
        bundle = json.load(f)
    prof = bundle["profile"]
    assert "error" not in prof and prof["node"] in bundle["nodes"]
    assert "error" not in bundle["nodes"][prof["node"]]
    assert bundle["critpaths"]
    events = devtime.kernel_events(os.path.join(prof["trace_dir"],
                                                "trace.json"))
    fused = [dur for name, _, dur in events if "fused_reconstruct" in name]
    assert fused and sum(fused) > 0, {name for name, _, _ in events}


def test_device_avg_ms_is_kernel_time(cuda_device):
    """devtime.device_avg_ms sums the capture's kernel records: at or
    under a CUDA-event bracket of the same calls, and above 0."""
    from seaweedfs_tpu_torch.utils import devtime

    a = rs_cuda.prepare_matrix(gf256.parity_matrix(10, 14), cuda_device)
    x = torch.from_numpy(_rand((10, 4 << 20), 31)).to(cuda_device)
    fn = lambda: rs_cuda.gf2_matmul(a, x, 4)  # noqa: E731
    dev_ms = devtime.device_avg_ms(fn, n=10)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        fn()
    end.record()
    end.synchronize()
    bracket_ms = start.elapsed_time(end) / 10
    assert 0 < dev_ms <= bracket_ms * 1.25


# --- the streaming ingest encode (ops/rs_ingest.py) --------------------------


def test_stream_encoder_rows_match_plain_on_two_threads(cuda_device):
    """StreamEncoder("cuda") on seeded [10, 1 MiB] rows staged in pinned
    arena slots, from two worker threads at once (each on its own lane):
    every parity equals K1's plain version and the numpy oracle's sample,
    gf2_matmul launches once a row, on the aligned path, and no row is
    encoded on the host."""
    import threading

    from seaweedfs_tpu_torch.ops import rs_ingest

    enc = rs_ingest.StreamEncoder("cuda")
    plain = rs_ingest.StreamEncoder("torch")
    rows = [_rand((10, 1 << 20), 100 + i) for i in range(8)]
    got: dict[int, np.ndarray] = {}
    errors = []

    def worker(ids):
        try:
            arena = rs_ingest.IngestArena(10, 1 << 20, slots=1, pin=True)
            for i in ids:
                buf = arena.stage(timeout_s=1)
                assert arena._tensors[0].is_pinned()
                buf[:] = rows[i]
                got[i] = enc.encode(buf)
                arena.reclaim(buf)
        except BaseException as e:  # noqa: BLE001 — collected
            errors.append(e)

    before = rs_cuda.gf2_matmul.launches
    aligned = rs_cuda.gf2_matmul.launches_by_path["aligned"]
    threads = [threading.Thread(target=worker, args=(range(j, 8, 2),))
               for j in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(120)
    assert not errors, errors[0]
    assert not any(th.is_alive() for th in threads)
    assert rs_cuda.gf2_matmul.launches == before + 8
    assert rs_cuda.gf2_matmul.launches_by_path["aligned"] == aligned + 8
    assert (enc.device_rows, enc.host_rows, enc.failed_rows) == (8, 0, 0)
    mat = gf256.parity_matrix(10, 14)
    for i in range(8):
        assert np.array_equal(got[i], plain.encode(rows[i])), i
        assert np.array_equal(got[i][:, :4096],
                              rs_cpu.apply_matrix_numpy(mat, rows[i][:, :4096]))


def test_stream_encoder_slot_rule_on_card(cuda_device):
    """When encode() returns, the row's event has completed and its
    worker's stream is idle: the H2D copy that read the slot is done, so
    the slot may go back to the pool for the next row."""
    from seaweedfs_tpu_torch.ops import rs_ingest

    enc = rs_ingest.StreamEncoder("cuda")
    arena = rs_ingest.IngestArena(10, 1 << 20, slots=1, pin=True)
    row = _rand((10, 1 << 20), 7)
    want = rs_ingest.StreamEncoder("torch").encode(row)
    for _ in range(3):
        buf = arena.stage(timeout_s=1)
        buf[:] = row
        parity = enc.encode(buf)
        lane = enc._local.lane
        assert lane.done.query(), "encode returned before the row's event"
        assert lane.stream.query(), "work still queued on the worker's stream"
        arena.reclaim(buf)
        assert np.array_equal(parity, want)


def test_ingest_pipeline_on_card_seals_like_offline(cuda_device, tmp_path):
    """A growing .dat streamed through a pipeline on the card (three
    10 MiB rows and a ragged tail) seals to the shard files the offline
    write_ec_files writes on the card, with one launch a streamed row
    plus the tail row's at seal."""
    from seaweedfs_tpu_torch.ingest import IngestConfig, IngestPipeline
    from seaweedfs_tpu_torch.ops import rs_ingest

    class Vol:
        id = 1
        dat_path = str(tmp_path / "1.dat")

        @property
        def content_size(self):
            return os.path.getsize(self.dat_path)

    open(Vol.dat_path, "wb").close()
    p = IngestPipeline(Vol(), rs_ingest.StreamEncoder("cuda"),
                       IngestConfig(backend="cuda"))
    before = rs_cuda.gf2_matmul.launches
    rng = np.random.default_rng(11)
    for n in (7 << 20, 10 << 20, (13 << 20) + 5, 2 << 20):
        with open(Vol.dat_path, "ab") as f:
            f.write(rng.integers(0, 256, n, np.uint8).tobytes())
        p.feed()
    assert p.seal(backend="cuda") is True
    assert (p.encoded_rows, p.rows_device, p.rows_host) == (3, 3, 0)
    assert rs_cuda.gf2_matmul.launches == before + 4
    base2 = str(tmp_path / "2")
    shutil.copyfile(Vol.dat_path, base2 + ".dat")
    ec.write_ec_files(base2, backend="cuda")
    for i in range(14):
        with open(str(tmp_path / "1") + ec.to_ext(i), "rb") as a, \
                open(base2 + ec.to_ext(i), "rb") as b:
            assert a.read() == b.read(), i


def test_cluster_generate_and_scrub_over_the_rpc_plane(cuda_device, tmp_path):
    """A two-server LocalCluster on the card: VolumeEcShardsGenerate over
    the RPC plane runs K1 (gf2_matmul) and writes shards sha256-equal to
    the plain version's; after the shards are mounted and pinned,
    VolumeEcShardsVerify(all_resident=True) runs B5 (csrc/scrub.cu) and
    reports 0 mismatching bytes for the volume."""
    import asyncio
    import hashlib
    import pathlib

    from seaweedfs_tpu_torch.pb import Stub, channel, volume_server_pb2 as vpb
    from seaweedfs_tpu_torch.server.cluster import LocalCluster

    rng = np.random.default_rng(29)
    items = [(i, int(rng.integers(0, 1 << 32)),
              rng.bytes(int(rng.integers(100, 400_000))))
             for i in range(1, 61)]
    # the plain version's shards, from the same .dat
    plain = tmp_path / "plain"
    plain.mkdir()
    v = Volume(str(plain), 1)
    for nid, cookie, data in items:
        v.write(nid, cookie, data)
    v.close()
    ec.write_ec_files(str(plain / "1"), backend="torch")
    want = {sid: hashlib.sha256((plain / f"1{ec.to_ext(sid)}").read_bytes())
            .hexdigest() for sid in range(14)}

    async def go():
        c = LocalCluster(n_volume_servers=2, base_dir=str(tmp_path / "c"),
                         ec_backend="cuda",
                         volume_kwargs={"ec_device_cache_mb": 2048})
        await c.start()
        try:
            vs = c.volume_servers[0]
            shutil.copy(plain / "1.dat", vs.store.locations[0].directory)
            shutil.copy(plain / "1.idx", vs.store.locations[0].directory)
            stub = Stub(channel(vs.grpc_url), vpb, "VolumeServer")
            await stub.VolumeMount(vpb.VolumeMountRequest(volume_id=1))
            await stub.VolumeMarkReadonly(vpb.VolumeMarkReadonlyRequest(
                volume_id=1))
            k0 = rs_cuda.gf2_matmul.launches + rs_cuda.gf2_matmul_small.launches
            await stub.VolumeEcShardsGenerate(
                vpb.VolumeEcShardsGenerateRequest(volume_id=1))
            assert rs_cuda.gf2_matmul.launches + \
                rs_cuda.gf2_matmul_small.launches > k0
            base = os.path.join(vs.store.locations[0].directory, "1")
            got = await asyncio.to_thread(lambda: {
                sid: hashlib.sha256(
                    pathlib.Path(base + ec.to_ext(sid)).read_bytes()
                ).hexdigest() for sid in range(14)})
            assert got == want
            await stub.VolumeEcShardsMount(vpb.VolumeEcShardsMountRequest(
                volume_id=1, shard_ids=list(range(14))))
            for _ in range(600):
                if vs.store.find_ec_volume(1).is_device_resident() and \
                        vs.store.ec_device_cache.resident_count(1) == 14:
                    break
                await asyncio.sleep(0.05)
            s0 = rs_resident.scrub.launches
            r = await stub.VolumeEcShardsVerify(vpb.VolumeEcShardsVerifyRequest(
                all_resident=True))
            assert rs_resident.scrub.launches > s0
            assert [row.volume_id for row in r.volumes] == [1]
            assert list(r.volumes[0].parity_mismatch_bytes) == [0, 0, 0, 0]
            assert r.volumes[0].bytes_verified > 0
        finally:
            await c.stop()

    asyncio.run(go())


def test_master_repairs_a_lost_server_with_k1_on_the_card(cuda_device,
                                                          tmp_path):
    """The master's repair plane on the card: three servers on
    -ec.backend cuda, shards 0-9 on server 0 and 10-13 on server 1; server
    1 stops, and the master rebuilds 10-13 with no shell verb: the
    rebuilder's VolumeEcShardsRebuild launches K1, and every shard on the
    live servers equals the plain version's encode of the same .dat."""
    import asyncio
    import hashlib
    import pathlib
    import time

    from seaweedfs_tpu_torch.pb import Stub, channel, volume_server_pb2 as vpb
    from seaweedfs_tpu_torch.repair import RepairConfig
    from seaweedfs_tpu_torch.server.cluster import LocalCluster

    rng = np.random.default_rng(31)
    plain = tmp_path / "plain"
    plain.mkdir()
    v = Volume(str(plain), 1)
    for nid in range(1, 41):
        v.write(nid, int(rng.integers(0, 1 << 32)),
                rng.bytes(int(rng.integers(100, 300_000))))
    v.close()
    ec.write_ec_files(str(plain / "1"), backend="torch")
    want = {sid: hashlib.sha256((plain / f"1{ec.to_ext(sid)}").read_bytes())
            .hexdigest() for sid in range(14)}

    async def go():
        c = LocalCluster(n_volume_servers=3, base_dir=str(tmp_path / "c"),
                         ec_backend="cuda", master_kwargs={
                             "ec_repair": RepairConfig(
                                 interval_seconds=0.25,
                                 backoff_base_seconds=0.2)})
        await c.start()
        try:
            vs0, vs1, _ = c.volume_servers
            c.master.repair.pause()
            for ext in (".dat", ".idx"):
                shutil.copy(plain / f"1{ext}", vs0.store.locations[0].directory)
            s0 = Stub(channel(vs0.grpc_url), vpb, "VolumeServer")
            s1 = Stub(channel(vs1.grpc_url), vpb, "VolumeServer")
            await s0.VolumeMount(vpb.VolumeMountRequest(volume_id=1))
            await s0.VolumeMarkReadonly(vpb.VolumeMarkReadonlyRequest(
                volume_id=1))
            await s0.VolumeEcShardsGenerate(
                vpb.VolumeEcShardsGenerateRequest(volume_id=1))
            await s0.VolumeEcShardsMount(vpb.VolumeEcShardsMountRequest(
                volume_id=1, shard_ids=list(range(14))))
            moved = [10, 11, 12, 13]
            await s1.VolumeEcShardsCopy(vpb.VolumeEcShardsCopyRequest(
                volume_id=1, shard_ids=moved, copy_ecx_file=True,
                copy_vif_file=True, source_data_node=vs0.grpc_url))
            await s1.VolumeEcShardsMount(vpb.VolumeEcShardsMountRequest(
                volume_id=1, shard_ids=moved))
            await s0.VolumeEcShardsUnmount(vpb.VolumeEcShardsUnmountRequest(
                volume_id=1, shard_ids=moved))
            await s0.VolumeEcShardsDelete(vpb.VolumeEcShardsDeleteRequest(
                volume_id=1, shard_ids=moved))
            await s0.VolumeUnmount(vpb.VolumeUnmountRequest(volume_id=1))

            def placement():
                locs = c.master.topo.lookup_ec_shards(1)
                return None if locs is None else [
                    sorted(n.url for n in nodes) for nodes in locs.locations]

            t_end = time.monotonic() + 60
            while placement() != [[vs0.url]] * 10 + [[vs1.url]] * 4:
                assert time.monotonic() < t_end, placement()
                await asyncio.sleep(0.1)
            k0 = rs_cuda.gf2_matmul.launches + rs_cuda.gf2_matmul_small.launches
            c.master.repair.resume()
            await vs1.stop()
            sched = c.master.repair
            t_end = time.monotonic() + 120
            while not (placement() and all(
                    any(u != vs1.url for u in us) for us in placement())
                    and sched.totals["completed"] >= 1
                    and sched.last_time_to_healthy_s is not None):
                assert time.monotonic() < t_end, sched.status()
                await asyncio.sleep(0.1)
            assert rs_cuda.gf2_matmul.launches + \
                rs_cuda.gf2_matmul_small.launches > k0
            result = sched.status()["volumes"]["1"]["last_result"]
            assert result["rebuilt"] == moved
            got = {}
            for vs in (c.volume_servers[0], c.volume_servers[2]):
                for p in pathlib.Path(vs.store.locations[0].directory).glob(
                        "1.ec[0-9][0-9]"):
                    got.setdefault(int(p.name[-2:]), set()).add(
                        hashlib.sha256(p.read_bytes()).hexdigest())
            assert got == {sid: {h} for sid, h in want.items()}
        finally:
            await c.stop()

    asyncio.run(go())


# ------------------------------------------------- the mesh on the card


def _two_lanes(cuda_device):
    from seaweedfs_tpu_torch.parallel import mesh as mesh_mod

    return mesh_mod.make_mesh(2, 1, devices=[cuda_device] * 2)


@pytest.mark.parametrize("layout", ["flat", "blockdiag"])
def test_sharded_reads_on_two_lanes_of_one_card(cuda_device, layout):
    """A lane-sharded volume on two lanes of one card: every burst is one
    ragged launch a lane with work, byte-equal to the one-device read, the
    CPU lanes' plain version and the oracle."""
    full = RSCodec(backend="numpy").encode_all(_rand((10, 3 << 20), 41))
    kw = dict(shard_quantum=1 << 20, mesh_min_shard_bytes=0, layout=layout)
    mesh = rs_resident.DeviceShardCache(device=cuda_device,
                                        mesh=_two_lanes(cuda_device), **kw)
    from seaweedfs_tpu_torch.parallel import mesh as mesh_mod

    plain = rs_resident.DeviceShardCache(
        device="cpu", mesh=mesh_mod.make_mesh(2, 1, devices=["cpu"] * 2), **kw)
    one = rs_resident.DeviceShardCache(device=cuda_device, **kw)
    for c in (mesh, plain, one):
        for sid in range(14):
            if sid not in (0, 11):
                c.put(1, sid, full[sid])
    assert mesh.placement(1) == "mesh" and len(mesh.device_stats()) == 2
    rng = np.random.default_rng(5)
    stripe = mesh.stripe
    reqs = [(0, int(rng.integers(0, (3 << 20) - 70_000)), int(n))
            for n in rng.choice([1, 4096, 33_000, 70_000], size=64)]
    reqs += [(0, stripe - 9, 5000), (11, 0, 1), (0, 999, (2 << 20) + 3)]
    kern = (rs_resident.fused_reconstruct_blockdiag if layout == "blockdiag"
            else rs_resident.fused_reconstruct)
    before = kern.launches
    got = rs_resident.reconstruct_intervals(mesh, 1, reqs)
    assert kern.launches - before == 2  # one a lane: both lanes have work
    want = [full[s][o : o + n].tobytes() for s, o, n in reqs]
    assert got == want
    assert rs_resident.reconstruct_intervals(plain, 1, reqs) == want
    assert rs_resident.reconstruct_intervals(one, 1, reqs) == want


def test_mesh_scrub_and_whole_pins_on_the_card(cuda_device):
    full = RSCodec(backend="numpy").encode_all(_rand((10, 1 << 20), 42))
    bad = full.copy()
    bad[13, 12_345] ^= 1
    c = rs_resident.DeviceShardCache(
        device=cuda_device, mesh=_two_lanes(cuda_device),
        shard_quantum=1 << 20, mesh_min_shard_bytes=2 << 20)
    small = RSCodec(backend="numpy").encode_all(_rand((10, 64 << 10), 43))
    for sid in range(14):
        c.put(1, sid, small[sid])   # whole, lane 0
        c.put(2, sid, small[sid])   # whole, lane 1
        c.put(3, sid, bad[sid])     # 1 MiB < 2 MiB: whole too
    assert {c.placement(1), c.placement(2)} == {0, 1}
    before = rs_resident.scrub.launches
    res, st = rs_resident.scrub_all_resident(c)
    assert rs_resident.scrub.launches - before == st["device_calls"]
    assert res[3][0] == [0, 0, 0, 1] and res[1][0] == res[2][0] == [0] * 4
    got = rs_resident.reconstruct_intervals(c, 2, [(0, 100, 5000)])
    assert got == [small[0][100:5100].tobytes()]
    sharded = rs_resident.DeviceShardCache(
        device=cuda_device, mesh=_two_lanes(cuda_device),
        shard_quantum=1 << 20, mesh_min_shard_bytes=0)
    for sid in range(14):
        sharded.put(4, sid, bad[sid])
    before = rs_resident.scrub.launches
    counts, span = rs_resident.scrub_volume(sharded, 4)
    assert rs_resident.scrub.launches - before == 2  # one a lane
    assert counts == [0, 0, 0, 1] and span == sharded._padded_len(1 << 20)


def test_distributed_apply_on_two_lanes_of_one_card(cuda_device):
    """distributed_apply_matrix and distributed_encode_blockdiag over a
    (2, 1) and a (2, 2) mesh of one card: one K1 launch a lane, byte-equal
    to the one-card K1 and the oracle."""
    from seaweedfs_tpu_torch.parallel import distributed as dist_mod
    from seaweedfs_tpu_torch.parallel import mesh as mesh_mod

    data = _rand((10, 1 << 20), 44)
    pm = gf256.parity_matrix(10, 14)
    want = rs_cpu.apply_matrix_numpy(pm, data)
    for shape in ((2, 1), (2, 2), (5, 1)):
        mesh = mesh_mod.make_mesh(*shape,
                                  devices=[cuda_device] * (shape[0] * shape[1]))
        before = rs_cuda.gf2_matmul.launches
        timing = {}
        got = dist_mod.distributed_apply_matrix(mesh, pm, data, timing=timing)
        assert rs_cuda.gf2_matmul.launches - before == mesh.size
        assert got.is_cuda and np.array_equal(got.cpu().numpy(), want)
        assert timing["k1_s"] > 0
        assert np.array_equal(
            dist_mod.distributed_encode_blockdiag(mesh, pm, data), want)
    assert np.array_equal(rs_cuda.apply_matrix(pm, data), want)
