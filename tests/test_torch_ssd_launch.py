"""The SSD-scan kernel's host side, on CPU tensors, and the arithmetic of
its products.

``launch_args`` turns a call into plain numbers (heads a block of each
kernel, grids, dynamic shared memory, scratch shapes, strides); the
kernels themselves run only on the card (``chip_smoke.py`` phases 2 and
11, which also check that the library's shared-memory sizes equal the
host's).  The kernels take their products on the tensor cores in 3xTF32:
each float32 operand split into a TF32 ``hi`` and a TF32 ``lo`` part.
``test_3xtf32_holds_the_card_limits`` emulates that arithmetic in plain
PyTorch and holds it, and a single-TF32 emulation, against float64 under
the limits ``chip_smoke.py`` holds the kernel to (``SSD_REL_TOL``).
"""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.ssd_scan import (KERNEL_SHAPES, heads_per_block,
                                          launch_args, smem_bytes,
                                          ssd_scan_plain)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

SMEM_LIMIT = 232448          # bytes of shared memory a block may use (H100)
# the reference's kernel cases (tests/test_torch_ssd.py) that the CUDA
# kernel builds: (B, S, H, P, G, N, chunk)
REF_CASES = [(1, 64, 2, 64, 1, 128, 16), (1, 128, 4, 64, 1, 64, 64)]


def _inputs(B, S, H, G, P, N, dtype=torch.float32):
    return (torch.zeros(B, S, H, P, dtype=dtype),
            torch.zeros(B, S, H, dtype=dtype),
            torch.zeros(B, S, G, N, dtype=dtype),
            torch.zeros(B, S, G, N, dtype=dtype),
            torch.zeros(B, H, P, N, dtype=dtype))


def _card_cases():
    """chip_smoke's SSD cases as the kernel sees them (S padded to a whole
    number of chunks, as ``ssd_sequence`` pads it)."""
    for tag, B, S, H, G, P, N, Q, _, _ in chip_smoke.SSD_CASES:
        yield pytest.param(B, -(-S // Q) * Q, H, G, P, N, Q, id=tag)


@pytest.mark.parametrize("B,S,H,G,P,N,Q", list(_card_cases()) + [
    pytest.param(B, S, H, G, P, N, Q, id=f"ref-{P}x{N}-q{Q}")
    for B, S, H, P, G, N, Q in REF_CASES])
def test_launch_args_at_every_case(B, S, H, G, P, N, Q):
    a = launch_args(*_inputs(B, S, H, G, P, N), chunk=Q)
    nc, tiles, group = S // Q, -(-Q // 64), H // G
    assert a.dims == (B, S, H, G, P, N, Q) and a.nc == nc
    for hb, most in ((a.heads_state, ssd.MAX_STATE_HEADS),
                     (a.heads_scan, ssd.MAX_HEADS)):
        assert 1 <= hb <= most and group % hb == 0
    assert a.grid_state == (nc, H // a.heads_state, B)
    assert a.grid_pass == (-(-P * N // 1024), H, B)
    assert a.grid_scan == (nc * (H // a.heads_scan) * B, tiles)
    assert a.smem_state == smem_bytes(P, N, Q, a.heads_state)[0]
    assert a.smem_scan == smem_bytes(P, N, Q, a.heads_scan)[1]
    assert max(a.smem_state, a.smem_scan) <= SMEM_LIMIT
    assert a.states_shape == (B, nc, H, P, N) and a.decay_shape == (B, nc, H)
    assert a.strides == (S * H * P, H * P, P, S * H, H, 1,
                         S * G * N, G * N, N, S * G * N, G * N, N)


def test_training_shape_shares_c_bt_across_all_heads():
    """Mamba2-130M (24 heads, one group): one C B^T a (batch row, chunk,
    query tile) for all 24 heads; the chunk states two heads a block."""
    a = launch_args(*_inputs(8, 2048, 24, 1, 64, 128), chunk=256)
    assert (a.heads_scan, a.heads_state) == (24, 2)
    assert a.grid_scan == (64, 4) and a.grid_state == (8, 12, 8)
    assert (a.smem_state, a.smem_scan) == (199680, 220160)


def test_two_groups_keep_heads_within_a_group():
    a = launch_args(*_inputs(2, 1024, 24, 2, 64, 128), chunk=256)
    for hb in (a.heads_state, a.heads_scan):
        assert 12 % hb == 0              # a head set never spans groups
    assert a.grid_scan[0] == 4 * (24 // a.heads_scan) * 2


@pytest.mark.parametrize("group,heads,per_set,most,want", [
    (24, 24, 256, 24, 24),     # 256 blocks fill 132 SMs
    (24, 24, 32, 24, 4),       # B=1: 32 x 6 sets = 192 >= 132
    (24, 24, 64, 2, 2),        # the chunk states' cap
    (12, 24, 8, 24, 1),        # no divisor fills the card: one head
    (7, 7, 100, 24, 1),        # 7 x 100 >= 132 only one head a block
    (1, 1, 1000, 24, 1),
])
def test_heads_per_block(group, heads, per_set, most, want):
    assert heads_per_block(group, heads, per_set, most) == want


@pytest.mark.parametrize("P,N", KERNEL_SHAPES)
def test_shared_memory_fits_every_chunk(P, N):
    for q in range(1, ssd.MAX_CHUNK + 1):
        for hb in range(1, ssd.MAX_STATE_HEADS + 1):
            assert smem_bytes(P, N, q, hb)[0] <= SMEM_LIMIT
        assert smem_bytes(P, N, q, ssd.MAX_HEADS)[1] <= SMEM_LIMIT


def test_strided_views_are_read_in_place():
    """x cut from a wider projection, as the model cuts it: its strides
    reach the kernel, no copy."""
    B, S, H, P, N = 2, 128, 4, 64, 128
    wide = torch.zeros(B, S, H * P + 2 * N)
    xdt = wide[..., :H * P].view(B, S, H, P)
    Bm = wide[..., H * P:H * P + N].view(B, S, 1, N)
    Cm = wide[..., H * P + N:].view(B, S, 1, N)
    a = launch_args(xdt, torch.zeros(B, S, H), Bm, Cm,
                    torch.zeros(B, H, P, N), chunk=64)
    assert a.xdt is xdt and a.Bm is Bm and a.Cm is Cm
    assert a.strides[:3] == (S * wide.shape[2], wide.shape[2], P)
    assert a.strides[6:9] == (S * wide.shape[2], wide.shape[2], N)


def test_unaligned_rows_are_copied():
    B, S, H, P, N = 1, 64, 2, 64, 128
    base = torch.zeros(B * S * H * P + 1)
    xdt = base[1:].view(B, S, H, P)            # 4-byte offset
    a = launch_args(xdt, *_inputs(B, S, H, 1, P, N)[1:], chunk=64)
    assert a.xdt is not xdt and a.xdt.is_contiguous()
    assert a.xdt.data_ptr() % 16 == 0


@pytest.mark.parametrize("change,match", [
    (dict(dtype=torch.float64), "float32"),
    (dict(P=16, N=32), r"\(P, N\)"),
    (dict(P=32, N=128), r"\(P, N\)"),
    (dict(S=512, Q=512), "chunk <= 256"),
    (dict(S=100, Q=64), "multiple of"),
    (dict(H=6, G=4), "G must divide H"),
])
def test_refuses_what_no_kernel_takes(change, match):
    d = dict(B=1, S=256, H=4, G=1, P=64, N=128, Q=64, dtype=torch.float32)
    d.update(change)
    ins = _inputs(d["B"], d["S"], d["H"], d["G"], d["P"], d["N"], d["dtype"])
    with pytest.raises(ValueError, match=match):
        launch_args(*ins, chunk=d["Q"])


# ---------------------------------------------------------------------------
# the kernel's 3xTF32 arithmetic, emulated
# ---------------------------------------------------------------------------

LOG2E = 1.0 / math.log(2.0)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 explicit mantissa bits) to nearest, ties
    away from zero, by bit masking, as the kernel rounds."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """a @ b with TF32 operands and float32 sums: 3 terms = hi hi + hi lo +
    lo hi (the kernel's split), 1 term = a single TF32 product."""
    ah, bh = _tf32(a), _tf32(b)
    if terms == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _ssd_emulated(xdt, dA, Bm, Cm, s0, chunk, terms):
    """The kernel's forward step by step: running sums in float64 (log2
    units), exponents taken in float64 and masked, then an fp32 exp2;
    C B^T once per group; the four products through ``_mm``."""
    B, S, H, P = xdt.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc, Q, rep = S // chunk, chunk, H // G
    x = xdt.reshape(B, nc, Q, H, P).permute(0, 1, 3, 2, 4)     # b c h q p
    cm = Cm.reshape(B, nc, Q, G, N).permute(0, 1, 3, 2, 4)     # b c g q n
    bm = Bm.reshape(B, nc, Q, G, N).permute(0, 1, 3, 2, 4)
    cum = (dA.double() * LOG2E).reshape(B, nc, Q, H).cumsum(2)
    cum = cum.permute(0, 1, 3, 2)                              # b c h q
    tril = torch.ones(Q, Q, dtype=torch.bool).tril()
    diff = cum[..., :, None] - cum[..., None, :]
    decay = torch.where(tril, torch.exp2(diff.float()), 0.0)
    scores = _mm(cm, bm.transpose(-1, -2), terms)              # b c g q q
    scores = scores.repeat_interleave(rep, dim=2)
    y = _mm(scores * decay, x, terms)
    tail = torch.exp2((cum[..., -1:] - cum).float())           # b c h q
    bh_ = bm.repeat_interleave(rep, dim=2)
    own = _mm((x * tail[..., None]).transpose(-1, -2), bh_, terms)
    total = torch.exp2(cum[..., -1].float())                   # b c h
    state, entering = s0.float(), []
    for c in range(nc):
        entering.append(state)
        state = state * total[:, c, :, None, None] + own[:, c]
    entering = torch.stack(entering, 1)                        # b c h p n
    ch_ = cm.repeat_interleave(rep, dim=2)
    y = y + _mm(ch_, entering.transpose(-1, -2), terms) * \
        torch.exp2(cum.float())[..., None]
    return y.permute(0, 1, 3, 2, 4).reshape(B, S, H, P), state


def _ssd_case(decays, seed=0, B=1, S=512, H=4, G=1, P=64, N=128):
    """Inputs as chip_smoke.py makes them: the model's decays (Mamba2's
    A = -linspace(1, 16, H), dt = softplus(N(0, 1))) or small ones (dt in
    [1e-3, 1e-1], A in [-1, -0.1]); s0 of unit scale."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x, Bm, Cm, s0 = r(B, S, H, P), r(B, S, G, N), r(B, S, G, N), r(B, H, P, N)
    if decays == "model":
        dt = torch.nn.functional.softplus(r(B, S, H))
        A = -torch.linspace(1.0, 16.0, H)
    else:
        dt = torch.from_numpy(rng.uniform(1e-3, 1e-1, (B, S, H))
                              .astype(np.float32))
        A = -torch.from_numpy(rng.uniform(0.1, 1.0, H).astype(np.float32))
    return x * dt[..., None], dt * A, Bm, Cm, s0


@pytest.mark.parametrize("decays", ["model", "small"])
def test_3xtf32_holds_the_card_limits(decays):
    """3xTF32 (the kernel's products) against float64 stays inside the
    limit chip_smoke.py holds the kernel to; a single TF32 product does
    not, which is why the kernel pays for the split."""
    tol = chip_smoke.SSD_REL_TOL[decays]
    xdt, dA, Bm, Cm, s0 = _ssd_case(decays)
    y64, s64 = ssd_scan_plain(xdt.double(), dA.double(), Bm.double(),
                              Cm.double(), s0.double(), chunk=256)
    errs = {}
    for terms in (3, 1):
        y, s = _ssd_emulated(xdt, dA, Bm, Cm, s0, 256, terms)
        errs[terms] = (
            float((y.double() - y64).abs().max() / y64.abs().max()),
            float((s.double() - s64).abs().max() / s64.abs().max()))
    assert max(errs[3]) <= tol, errs
    assert max(errs[1]) > tol, errs


def test_tf32_rounds_to_nearest():
    one = torch.tensor([1.0, -1.0])
    ulp = 2.0 ** -10
    x = torch.tensor([1 + 0.49 * ulp, 1 + 0.51 * ulp, 1 + 0.5 * ulp,
                      -(1 + 0.51 * ulp)])
    got = _tf32(x)
    assert got.tolist() == [1.0, 1 + ulp, 1 + ulp, -(1 + ulp)]
    assert torch.equal(_tf32(one), one)
    # hi + lo keeps what a single TF32 value drops
    v = torch.tensor([math.pi], dtype=torch.float32)
    hi = _tf32(v)
    lo = _tf32(v - hi)
    assert abs(float(hi + lo) - math.pi) < abs(float(hi) - math.pi) / 100
