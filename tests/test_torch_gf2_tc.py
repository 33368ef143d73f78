"""The tensor-core formulation of the port's GF(2) kernel, on the CPU.

csrc/gf2_matmul.cu computes the bitsliced apply with the binary mma
(m16n8k128 b1 AND+POPC): the data operand is a byte transpose of the
shards, the matrix operand is built from the prepared bit-major matrix in
the kernel's fragment and N order, the parity is bit 0 of each count and a
byte is packed with one 32-bit multiply sum.  rs_cuda.b1_matrix_operand,
b1_data_operand and _apply_b1_model repeat that integer arithmetic in
plain PyTorch; here they are held byte for byte (tolerance 0: GF(2) is
exact) against the JAX package's apply (rs_tpu kernel "xla") on the same
numpy-seeded inputs.  The kernel itself runs only on the card
(test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import gf256 as jax_gf256
from seaweedfs_tpu.ops import rs_tpu
from seaweedfs_tpu_torch.ops import rs_cuda

KS = (1, 3, 10, 13, 16, 40, 64)


def _rand(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _jax_apply(mat: np.ndarray, x: np.ndarray) -> np.ndarray:
    """The JAX package's device apply, all m_pad rows."""
    a_j = rs_tpu.prepare_matrix(mat)
    return np.asarray(rs_tpu.apply_matrix_device(a_j, jnp.asarray(x), kernel="xla"))


@pytest.mark.parametrize("k", KS)
def test_model_matches_jax_every_m_out(k):
    """Every m_out from 1 to m_pad, a ragged B: the formulation's bytes
    equal the JAX package's."""
    m = {1: 3, 3: 5, 10: 4, 13: 9, 16: 14, 40: 16, 64: 7}[k]
    mat = _rand((m, k), 10 + k)
    x = _rand((k, 1000 + k), 20 + k)
    want = _jax_apply(mat, x)
    a = rs_cuda.from_jax_prepared(np.asarray(rs_tpu.prepare_matrix(mat)), device="cpu")
    m_pad = a.shape[0] // 8
    assert want.shape[0] == m_pad
    for m_out in range(1, m_pad + 1):
        got = rs_cuda._apply_b1_model(a, torch.from_numpy(x), m_out)
        assert np.array_equal(got.numpy(), want[:m_out]), m_out


@pytest.mark.parametrize("b", [1, 15, 16, 17, 1023, 1025, 4099])
def test_model_ragged_b_encode_and_one_row(b):
    """The encode matrix (four rows) and a one-row reconstruct matrix at
    ragged widths."""
    x = _rand((10, b), b)
    for mat in (jax_gf256.parity_matrix(10, 14),
                jax_gf256.reconstruction_matrix(
                    10, 14, [i for i in range(14) if i not in (0, 11)], [0])[0]):
        a = rs_cuda.prepare_matrix(mat, device="cpu")
        got = rs_cuda._apply_b1_model(a, torch.from_numpy(x), mat.shape[0])
        assert np.array_equal(got.numpy(), _jax_apply(mat, x)[: mat.shape[0]])


def test_model_blockdiag_g4():
    """The g=4 block-diagonal system A[128, 384] on segment-stacked input,
    16 output rows in 4 blocks of 32 bits; its all-zero K steps are what
    the kernel skips."""
    parity = jax_gf256.parity_matrix(10, 14)
    x = _rand((10, 4 * 777), 5)
    stacked = rs_tpu.stack_segments(x)
    blk = rs_tpu.blockdiag_system(parity)
    a = rs_cuda.prepare_matrix_blockdiag(parity, device="cpu")
    assert tuple(a.shape) == (128, 384)
    got = rs_cuda._apply_b1_model(a, torch.from_numpy(stacked), 16)
    assert np.array_equal(got.numpy(), _jax_apply(blk, stacked)[:16])
    assert np.array_equal(rs_tpu.unstack_segments(got.numpy(), 4),
                          rs_tpu.apply_matrix(parity, x, kernel="xla"))
    # the operand of block g is zero outside its shards' K steps
    op = rs_cuda.b1_matrix_operand(a, 40, 16)  # [4 blocks, 3 K steps, 4, 32]
    nonzero = (op != 0).any(dim=(2, 3))
    assert nonzero.tolist() == [[True, False, False], [True, True, False],
                                [False, True, False], [False, True, True]]


@pytest.mark.parametrize("k", [3, 10, 40])
@pytest.mark.parametrize("m_out", [1, 4, 6])
def test_matrix_operand_bits(k, m_out):
    """Each bit of the matrix operand is the prepared matrix entry the
    kernel's fragment and N order say it is."""
    mat = _rand((max(m_out, 4), k), 100 * k + m_out)
    a = rs_cuda.prepare_matrix(mat, device="cpu")
    m_pad, k_pad = a.shape[0] // 8, a.shape[1] // 8
    op = rs_cuda.b1_matrix_operand(a, k, m_out).numpy()
    nq = 1 if m_out == 1 else 4
    assert op.shape == (-(-m_out // 4), -(-k // 16), nq, 32)
    an = a.numpy()
    for blk, ks, q, lane in np.ndindex(op.shape):
        g, t = lane // 4, lane % 4
        p, i = (0, g) if m_out == 1 else (4 * blk + g // 2, 2 * q + g % 2)
        for r in range(4):
            s = 16 * ks + t + 4 * r
            for j in range(8):
                want = s < k and p < m_pad and an[i * m_pad + p, j * k_pad + s] != 0
                assert bool((int(op[blk, ks, q, lane]) >> (8 * r + j)) & 1) == want


@pytest.mark.parametrize("k", [1, 10, 17, 64])
def test_data_operand_is_a_byte_transpose(k):
    x = _rand((k, 37), k)
    d = rs_cuda.b1_data_operand(torch.from_numpy(x)).numpy()
    assert d.shape == (-(-k // 16), 4, 37)
    for ks, t, c in np.ndindex(d.shape):
        want = sum(int(x[s, c]) << (8 * r)
                   for r, s in enumerate(range(16 * ks + t, 16 * ks + 16, 4)) if s < k)
        assert int(d[ks, t, c]) == want


def test_pack_counts_every_parity_pattern():
    """The kernel's byte pack (two masked low-byte words, one multiply sum,
    top byte) equals sum_i (count_i & 1) << i for every parity pattern,
    with counts up to 512 (8 * k_pad at k_pad 64) so no carry can reach
    the top byte."""
    rng = np.random.default_rng(1)
    pats = np.arange(256)
    bits = (pats[:, None] >> np.arange(8)) & 1
    for _ in range(8):
        counts = 2 * rng.integers(0, 257, (256, 8)) + bits
        got = rs_cuda._pack_counts(torch.from_numpy(counts))
        assert np.array_equal(got.numpy(), pats.astype(np.uint8))


def test_popcount32_matches_python():
    w = np.random.default_rng(2).integers(0, 1 << 32, 1000, dtype=np.int64)
    got = rs_cuda._popcount32(torch.from_numpy(w)).numpy()
    assert got.tolist() == [bin(int(v)).count("1") for v in w]


def test_kernel_choice_by_shape():
    """CUDA calls pick their kernel by shape alone: one output row on
    16-byte-aligned rows up to SMALL_ONE_ROW_BYTES takes the CUDA-core
    kernel, everything else the tensor cores."""
    limit = rs_cuda.SMALL_ONE_ROW_BYTES
    buf = torch.zeros(10 * (limit + 16) + 16, dtype=torch.uint8)
    base = (-buf.data_ptr()) % 16  # a 16-byte-aligned start

    def view(b, shift=0):
        return buf[base + shift : base + shift + 10 * b].view(10, b)

    small, tc = rs_cuda.gf2_matmul_small, rs_cuda.gf2_matmul
    assert rs_cuda._kernel_for(view(4096), 1) is small
    assert rs_cuda._kernel_for(view(limit), 1) is small
    assert rs_cuda._kernel_for(view(limit + 16), 1) is tc
    assert rs_cuda._kernel_for(view(4096 + 8), 1) is tc
    assert rs_cuda._kernel_for(view(4096, shift=4), 1) is tc
    assert rs_cuda._kernel_for(view(4096), 2) is tc
