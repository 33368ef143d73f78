"""The PyTorch port's codec layer held against the JAX package.

Inputs come from a numpy seed and go through both packages; GF(256) is
exact arithmetic, so every comparison is byte equality (tolerance 0).  The
JAX side runs as its own tests run it on the CPU (rs_tpu kernel "xla", or
"pallas" in interpret mode at small B); the port side runs its plain
PyTorch version on CPU tensors.  The kernel's own tests, which need the
card, are in test_torch_cuda.py.
"""
import itertools

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import gf256 as jax_gf256
from seaweedfs_tpu.ops import rs_tpu
from seaweedfs_tpu.ops.rs import RSCodec as JaxRSCodec
from seaweedfs_tpu_torch.ops import gf256, rs_cpu, rs_cuda
from seaweedfs_tpu_torch.ops.rs import RSCodec

ALL_PATTERNS = [
    missing
    for r in range(1, 5)
    for missing in itertools.combinations(range(14), r)
]


def _rand(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


# --- gf256 copy ---------------------------------------------------------------


def test_gf256_tables_equal():
    assert np.array_equal(gf256.EXP_TABLE, jax_gf256.EXP_TABLE)
    assert np.array_equal(gf256.LOG_TABLE, jax_gf256.LOG_TABLE)
    assert np.array_equal(gf256.mul_table(), jax_gf256.mul_table())
    assert np.array_equal(gf256.build_matrix(10, 14), jax_gf256.build_matrix(10, 14))
    m = _rand((5, 7), 1)
    assert np.array_equal(gf256.expand_to_gf2(m), jax_gf256.expand_to_gf2(m))


def test_reconstruction_matrix_every_pattern_equal():
    assert len(ALL_PATTERNS) == 1470
    for missing in ALL_PATTERNS:
        present = [i for i in range(14) if i not in missing]
        r, use = gf256.reconstruction_matrix(10, 14, present, list(missing))
        rj, usej = jax_gf256.reconstruction_matrix(10, 14, present, list(missing))
        assert use == usej
        assert np.array_equal(r, rj), missing


# --- prepared matrix ------------------------------------------------------------


@pytest.mark.parametrize(
    "name,m_gf",
    [
        ("parity", jax_gf256.parity_matrix(10, 14)),
        ("one_row", _rand((1, 10), 2)),
        ("k16_m14", _rand((14, 16), 3)),
        ("k3_m5", _rand((5, 3), 4)),
    ],
)
def test_prepare_matrix_equal(name, m_gf):
    want = np.asarray(rs_tpu.prepare_matrix(m_gf))
    assert np.array_equal(rs_cuda.prepare_matrix_numpy(m_gf), want)
    got = rs_cuda.prepare_matrix(m_gf, device="cpu")
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), want)
    carried = rs_cuda.from_jax_prepared(want, device="cpu")
    assert np.array_equal(carried.numpy(), want)
    blk = np.asarray(rs_tpu.prepare_matrix_blockdiag(m_gf))
    assert np.array_equal(
        rs_cuda.prepare_matrix_blockdiag(m_gf, device="cpu").numpy(), blk
    )


def test_from_jax_prepared_rejects_bad_shapes():
    with pytest.raises(ValueError):
        rs_cuda.from_jax_prepared(np.zeros((30, 128), np.int8), device="cpu")
    with pytest.raises(ValueError):
        rs_cuda.from_jax_prepared(np.full((32, 128), 2, np.int8), device="cpu")


# --- apply entry points ---------------------------------------------------------


@pytest.mark.parametrize("k", range(1, 17))
def test_apply_matrix_random(k):
    """Random matrices with k 1-16, m 1-14 and ragged B: the port's plain
    version equals the numpy oracle and the JAX package's xla kernel."""
    rng = np.random.default_rng(100 + k)
    for m in (1, 4, 5, 14):
        mat = rng.integers(0, 256, (m, k), dtype=np.uint8)
        for b in (1, 127, 129, 5000):
            x = rng.integers(0, 256, (k, b), dtype=np.uint8)
            got = rs_cuda.apply_matrix(mat, x, device="cpu")
            assert np.array_equal(got, rs_cpu.apply_matrix_numpy(mat, x)), (m, b)
            assert np.array_equal(
                got, rs_tpu.apply_matrix(mat, x, kernel="xla")
            ), (m, b)


@pytest.mark.parametrize("b", [1, 127, 129, 5000])
def test_apply_matrix_vs_pallas_interpret(b):
    """The JAX package's Pallas kernel (interpret mode) on the encode and
    one-row reconstruct matrices."""
    x = _rand((10, b), b)
    for mat in (jax_gf256.parity_matrix(10, 14), _rand((1, 10), b + 1)):
        want = rs_tpu.apply_matrix(mat, x, kernel="pallas")
        assert np.array_equal(rs_cuda.apply_matrix(mat, x, device="cpu"), want)


@pytest.mark.parametrize("k,m,b", [(10, 4, 5000), (10, 1, 129), (16, 14, 127), (3, 2, 1)])
def test_apply_matrix_device_and_flat(k, m, b):
    import jax.numpy as jnp

    mat = _rand((m, k), k * m + b)
    x = _rand((k, b), b + 7)
    a_j = rs_tpu.prepare_matrix(mat)
    a_t = rs_cuda.from_jax_prepared(np.asarray(a_j), device="cpu")
    want = np.asarray(rs_tpu.apply_matrix_device(a_j, jnp.asarray(x), kernel="xla"))
    got = rs_cuda.apply_matrix_device(a_t, torch.from_numpy(x), k_true=k)
    assert np.array_equal(got.numpy(), want)
    want_flat = np.asarray(
        rs_tpu.apply_matrix_device_flat(
            a_j, jnp.asarray(x.reshape(-1)), k=k, m=m, kernel="xla"
        )
    )
    got_flat = rs_cuda.apply_matrix_device_flat(
        a_t, torch.from_numpy(x.reshape(-1)), k=k, m=m
    )
    assert np.array_equal(got_flat.numpy(), want_flat)
    with pytest.raises(ValueError):
        rs_cuda.apply_matrix_device(a_t, torch.from_numpy(x), k_true=k + 1)


@pytest.mark.parametrize("b", [256, 5000, 4 * 1000 + 3])
def test_apply_matrix_blockdiag(b):
    """Block-diagonal g=4 layout (and its indivisible-B fallback) equals
    the JAX package's blockdiag path (Pallas, interpret mode)."""
    mat = jax_gf256.parity_matrix(10, 14)
    x = _rand((10, b), b)
    want = rs_tpu.apply_matrix_blockdiag(mat, x)
    assert np.array_equal(rs_cuda.apply_matrix_blockdiag(mat, x, device="cpu"), want)
    assert np.array_equal(want, rs_cpu.apply_matrix_numpy(mat, x))


def test_stack_unstack_equal():
    x = _rand((10, 4096), 9)
    s = rs_cuda.stack_segments(x)
    assert np.array_equal(s, rs_tpu.stack_segments(x))
    out = _rand((16, 1024), 10)
    assert np.array_equal(
        rs_cuda.unstack_segments(out, 4), rs_tpu.unstack_segments(out, 4)
    )
    assert np.array_equal(rs_cuda.blockdiag_system(x[:4]), rs_tpu.blockdiag_system(x[:4]))


# --- erasure patterns and the codec ---------------------------------------------


def test_every_erasure_pattern_reconstructs():
    """All 1,470 patterns with 1-4 shards missing, port (plain version)
    against the numpy-encoded original."""
    data = _rand((10, 97), 11)
    full = RSCodec(backend="numpy").encode_all(data)
    codec = RSCodec(backend="torch")
    for missing in ALL_PATTERNS:
        shards = {i: full[i] for i in range(14) if i not in missing}
        got = codec.reconstruct(shards)
        assert sorted(got) == list(missing)
        for i in missing:
            assert np.array_equal(got[i], full[i]), (missing, i)


def test_sampled_erasure_patterns_match_jax():
    data = _rand((10, 300), 12)
    full = RSCodec(backend="numpy").encode_all(data)
    port, ref = RSCodec(backend="torch"), JaxRSCodec(backend="xla")
    rng = np.random.default_rng(13)
    for idx in rng.choice(len(ALL_PATTERNS), 40, replace=False):
        missing = ALL_PATTERNS[idx]
        shards = {i: full[i] for i in range(14) if i not in missing}
        got, want = port.reconstruct(shards), ref.reconstruct(shards)
        assert sorted(got) == sorted(want)
        for i in got:
            assert np.array_equal(got[i], want[i]), (missing, i)


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_codec_roundtrip(backend):
    codec = RSCodec(backend=backend)
    data = _rand((10, 1000), 14)
    full = codec.encode_all(data)
    assert np.array_equal(full, JaxRSCodec(backend="numpy").encode_all(data))
    assert codec.verify(full)
    full[12, 5] ^= 1
    assert not codec.verify(full)
    full[12, 5] ^= 1
    got = codec.reconstruct({i: full[i] for i in (1, 2, 3, 4, 6, 7, 8, 9, 11, 13)})
    for i in (0, 5, 10, 12):
        assert np.array_equal(got[i], full[i])


def test_native_codec_matches_oracle():
    mat = jax_gf256.parity_matrix(10, 14)
    x = _rand((10, 4099), 15)
    assert np.array_equal(
        rs_cpu.apply_matrix_native(mat, x), rs_cpu.apply_matrix_numpy(mat, x)
    )


def test_cpu_tensor_takes_plain_version_only():
    """The plain version runs because the tensor lies on the CPU; the
    kernel wrapper itself refuses CPU tensors instead of falling back."""
    a = rs_cuda.prepare_matrix(jax_gf256.parity_matrix(10, 14), device="cpu")
    x = torch.from_numpy(_rand((10, 64), 16))
    before = rs_cuda.gf2_matmul.launches
    rs_cuda.apply_matrix_device(a, x)
    assert rs_cuda.gf2_matmul.launches == before
    with pytest.raises(ValueError):
        rs_cuda.gf2_matmul(a, x, 4)

