"""The port's CUDA kernel on the card: gf2_matmul against its plain
PyTorch version and the numpy oracle, byte for byte, and the EC entry
points through it.

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

from seaweedfs_tpu_torch.ops import gf256, rs_cpu, rs_cuda
from seaweedfs_tpu_torch.ops.rs import RSCodec
from seaweedfs_tpu_torch.storage import ec
from seaweedfs_tpu_torch.storage.volume import Volume


def _rand(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the gf2_matmul kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "k,m,b",
    [(10, 4, 4 * 1024 * 1024 + 37), (10, 1, 4096), (16, 14, 65537),
     (40, 16, 1 << 20), (64, 56, 3001), (1, 1, 1), (10, 4, 4098),
     (13, 3, 4099), (7, 5, 3)],
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


@pytest.mark.parametrize("shift", [1, 2, 3])
def test_gf2_matmul_unaligned_views(cuda_device, shift):
    """Row starts off a 4-byte boundary take the kernel's funnel-shift
    loads; the end of the buffer is the last row's ragged end."""
    mat = gf256.parity_matrix(10, 14)
    a = rs_cuda.prepare_matrix(mat, device=cuda_device)
    buf = torch.from_numpy(_rand((10 * 5001 + shift,), 5)).to(cuda_device)
    x = buf[shift:].view(10, 5001)
    assert x.data_ptr() % 4
    assert torch.equal(rs_cuda.gf2_matmul(a, x, 4), rs_cuda._apply_torch(a, x, 4))


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
