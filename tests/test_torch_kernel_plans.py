"""The launch plans of the port's split kernels, checked on the CPU: the
host functions that cut the work of ``flash_decode`` into splits of S,
that of the clipped-mean kernel (``dp_clip._scale_mean_kernel``, Triton)
into column ranges and that of the norms pass (``dp_clip._sqnorm_kernel``,
Triton) into row tiles and column ranges, and a PyTorch model of each
kernel's arithmetic under its plan, held against the plain versions and
the JAX package's oracles; and a model of the tensor-core
``ssd_intra_chunk`` kernel's tile arithmetic (``csrc/ssd_intra_tc.cu``).

The kernels themselves run only on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).  Inputs are made with numpy from a seed.  Tolerances:
1e-6 in f32 for the split-and-merge model against the plain version (the
same softmax, merged in another order); 1e-6 for the clipped-mean and
norms models (f32 sums in another order); for the SSD model the bf16
tolerance of ``chip_smoke.py`` (rtol 5e-2, atol 1% of max |y|: the decayed
scores and y are rounded to bf16).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn.ref import flash_decode_ref as r_flash_ref
from repro.kernels.dp_clip.ops import dp_clip_mean_noise_cohort as r_clip
from repro.kernels.dp_clip.ref import dp_clip_mean_flat_ref as r_clip_flat
from repro.kernels.ssd_scan.ref import ssd_intra_chunk_ref as r_ssd_ref

from repro_torch.kernels.dp_clip import dp_clip, ref as clip_ref
from repro_torch.kernels.flash_attn import flash_attn
from repro_torch.kernels.flash_attn.ref import flash_decode_ref
from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_ref

# (B, S, H, Hkv, Dh, window, softcap, pos range): chip_smoke.py's
# FLASH_CASES, the full-width decode first
FLASH_CASES = [(8, 2112, 32, 32, 64, 0, 0.0, (2048, 2112)),
               (2, 256, 8, 2, 64, 0, 0.0, (128, 256)),
               (1, 512, 4, 4, 128, 128, 0.0, (256, 512)),
               (3, 384, 6, 2, 32, 100, 0.0, (192, 384)),
               (2, 128, 4, 4, 64, 0, 50.0, (64, 128)),
               (2, 20, 4, 4, 32, 0, 0.0, (0, 20)),
               (2, 267, 8, 2, 256, 7, 0.0, (0, 267)),
               (4, 100, 4, 1, 64, 0, 0.0, (0, 1)),
               (8, 2112, 32, 32, 64, 0, 0.0, (0, 1)),
               (8, 2112, 32, 32, 64, 300, 0.0, (1000, 1100)),
               (2, 1024, 56, 8, 128, 0, 0.0, (512, 1024)),
               (2, 512, 8, 4, 256, 0, 50.0, (256, 512))]
H100_SMS = 132
SM_COUNTS = (H100_SMS, 114, 8)     # SXM, PCIe, a small part


@pytest.fixture
def no_device(monkeypatch):
    """Any read of the card or of a tensor's value fails the test."""
    def refuse(*a, **k):
        raise AssertionError("the plan read a device value")
    monkeypatch.setattr(torch.cuda, "get_device_properties", refuse)
    monkeypatch.setattr(torch.Tensor, "item", refuse)
    monkeypatch.setattr(torch.Tensor, "tolist", refuse)


# ---------------------------------------------------------------------------
# flash_decode: the split plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_sm", SM_COUNTS)
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_split_plan_covers_the_keys_once(no_device, case, n_sm):
    """Split s takes chunks s, s + n_split, ...: every key once, every
    split at least one chunk, and the splits' key counts within one chunk
    of each other."""
    B, S, H, Hkv = case[:4]
    n_split, chunk = flash_attn.split_plan(S, B, H, Hkv, n_sm)
    assert type(n_split) is int and type(chunk) is int
    assert chunk % 64 == 0                  # the kernel's launch check
    seen = np.zeros(S, np.int64)
    sizes = []
    for s in range(n_split):
        keys = [j for c in range(s, -(-S // chunk), n_split)
                for j in range(c * chunk, min((c + 1) * chunk, S))]
        assert keys, f"split {s} is empty"
        seen[keys] += 1
        sizes.append(len(keys))
    assert (seen == 1).all()
    assert max(sizes) - min(sizes) <= chunk
    assert (n_split, chunk) == flash_attn.split_plan(S, B, H, Hkv, n_sm)


def test_split_plan_at_full_width_fills_the_card(no_device):
    """zamba2-1.2b's decode (B=8, S=2112, H=Hkv=32) on 132 SMs: of the
    1 to 4 splits that fit one wave of BLOCKS_PER_SM blocks per SM, 3 deal
    the 33 chunks of 64 keys out evenly (11 each): 768 blocks of one
    head."""
    B, S, H, Hkv = FLASH_CASES[0][:4]
    n_split, chunk = flash_attn.split_plan(S, B, H, Hkv, H100_SMS)
    assert (n_split, chunk) == (3, 64)
    assert flash_attn.heads_per_block(H // Hkv) == 1
    assert flash_attn.BLOCKS_PER_SM * H100_SMS // (B * Hkv) == 4
    assert -(-S // chunk) % n_split == 0


@pytest.mark.parametrize("n_chunks,most,want", [(33, 4, 3), (33, 8, 7),
                                                (100, 8, 5), (7, 8, 7),
                                                (13, 4, 2), (16, 6, 4)])
def test_split_plan_deals_the_chunks_out_evenly(no_device, n_chunks, most,
                                                want):
    """Of the split counts from most / 2 to ``most``, the largest of those
    with the most even deal."""
    S = n_chunks * flash_attn.CHUNK_KEYS
    n_sm = most * 4 // flash_attn.BLOCKS_PER_SM        # blocks = B = 4
    assert flash_attn.BLOCKS_PER_SM * n_sm // 4 == most
    assert flash_attn.split_plan(S, 4, 1, 1, n_sm)[0] == want


@pytest.mark.parametrize("rep,rb", [(1, 1), (2, 2), (3, 4), (4, 4), (7, 8),
                                    (8, 8), (16, 8)])
def test_heads_per_block(rep, rb):
    assert flash_attn.heads_per_block(rep) == rb


# ---------------------------------------------------------------------------
# flash_decode: a PyTorch model of split-and-merge against the plain version
# ---------------------------------------------------------------------------

def split_merge_model(q, k, v, pos, *, window, softcap, n_split, chunk):
    """The kernels' arithmetic in f32: per split the (m, l, acc) of the keys
    of its chunks that the mask admits (an empty split gives m = -inf,
    l = 0), a row whose mask admits no key taking every key with logit 0;
    then the merge of the splits in split order."""
    B, S, Hkv, Dh = k.shape
    rep = q.shape[1] // Hkv
    kk = k.repeat_interleave(rep, dim=2)
    vv = v.repeat_interleave(rep, dim=2)
    logits = torch.einsum("bhd,bshd->bhs", q, kk) * Dh ** -0.5
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    p64 = pos.long()
    lo = (p64 - window + 1).clamp(min=0) if window > 0 else 0 * p64
    hi = p64.clamp(max=S - 1)
    uniform = lo > hi
    lo = torch.where(uniform, 0, lo)
    hi = torch.where(uniform, S - 1, hi)
    logits = torch.where(uniform[:, None, None], 0.0, logits)
    idx = torch.arange(S)
    admitted = (idx >= lo[:, None]) & (idx <= hi[:, None])          # (B, S)
    ms, ls, accs = [], [], []
    for s in range(n_split):
        own = admitted & ((idx // chunk) % n_split == s)
        x = logits.masked_fill(~own[:, None, :], float("-inf"))
        m = x.max(dim=-1).values                                    # (B, H)
        p = torch.where(own[:, None, :], torch.exp(x - m[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bhs,bshd->bhd", p, vv))
    M = torch.stack(ms).max(dim=0).values
    L = torch.zeros_like(M)
    A = torch.zeros_like(q)
    for m, l, acc in zip(ms, ls, accs):                             # in order
        f = torch.where(m == float("-inf"), 0.0, torch.exp(m - M))
        L = L + l * f
        A = A + acc * f[..., None]
    return A / L[..., None]


def _merge_inputs(B, S, H, Hkv, Dh, pos, seed=0):
    rng = np.random.default_rng(seed + S + H)
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    return q, k, v, np.asarray(pos, np.int32)


# (B, S, H, Hkv, Dh, window, softcap, pos, n_sm): rows with splits the mask
# leaves empty, a window across a split boundary, pos = 0, rows whose mask
# admits no key (pos < 0; a window wholly past the cache), GQA, softcap
MERGE_CASES = {
    "empty_splits": (4, 2112, 8, 8, 64, 0, 0.0, [0, 100, 1000, 2111], 16),
    "window_across_splits": (2, 2112, 8, 8, 64, 300, 0.0, [1000, 1100],
                             H100_SMS),
    "pos0": (3, 512, 4, 2, 32, 0, 0.0, [0, 0, 511], H100_SMS),
    "no_key": (3, 256, 4, 4, 64, 5, 0.0, [-1, 300, 100], 8),
    "gqa_7": (2, 1024, 56, 8, 128, 0, 0.0, [512, 1023], H100_SMS),
    "softcap_gqa_2": (2, 512, 8, 4, 256, 0, 50.0, [256, 511], H100_SMS),
    "one_split": (2, 20, 4, 4, 32, 0, 0.0, [19, 7], H100_SMS),
}


@pytest.mark.parametrize("name", MERGE_CASES)
def test_split_merge_model_matches_plain_f32(name):
    B, S, H, Hkv, Dh, window, softcap, pos, n_sm = MERGE_CASES[name]
    q, k, v, pos = _merge_inputs(B, S, H, Hkv, Dh, pos)
    if softcap:
        q = q * 4
    n_split, chunk = flash_attn.split_plan(S, B, H, Hkv, n_sm)
    assert n_split > 1 or name == "one_split"
    qt, kt, vt, pt = map(torch.from_numpy, (q, k, v, pos))
    got = split_merge_model(qt, kt, vt, pt, window=window, softcap=softcap,
                            n_split=n_split, chunk=chunk)
    want = flash_decode_ref(qt, kt, vt, pt, window=window, softcap=softcap)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    jax_want = r_flash_ref(*map(jnp.asarray, (q, k, v, pos)), window=window,
                           softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_want), rtol=1e-5,
                               atol=1e-5)


def test_split_merge_cases_exercise_what_they_name():
    """The merge cases hold the splits they are named for."""
    B, S, H, Hkv, Dh, window, _, pos, n_sm = MERGE_CASES[
        "window_across_splits"]
    n_split, chunk = flash_attn.split_plan(S, B, H, Hkv, n_sm)
    assert n_split > 1
    assert all((p - window + 1) // chunk != p // chunk for p in pos)
    B, S, H, Hkv, *_, pos, n_sm = MERGE_CASES["empty_splits"]
    n_split, chunk = flash_attn.split_plan(S, B, H, Hkv, n_sm)
    assert min(pos) // chunk < n_split - 1 and max(pos) // chunk >= n_split
    *_, window, _, pos, _ = MERGE_CASES["no_key"]
    S = MERGE_CASES["no_key"][1]
    assert pos[0] < 0 and pos[1] - window + 1 > S - 1


# ---------------------------------------------------------------------------
# the clipped mean: the column plan
# ---------------------------------------------------------------------------

FULL_D, FULL_B = 317124, 128


def _ranges(k, d, n_sm):
    per, span = dp_clip.mean_plan(k, d, n_sm)
    return per, span, [(m, p * span, min((p + 1) * span, d))
                       for m in range(k) for p in range(per)]


@pytest.mark.parametrize("n_sm", SM_COUNTS)
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("d", [FULL_D, 4093, 1031, 37])
def test_column_plan_covers_every_output_once(no_device, k, d, n_sm):
    per, span, ranges = _ranges(k, d, n_sm)
    assert type(per) is int and type(span) is int and span % 16 == 0
    seen = np.zeros((k, d), np.int64)
    for m, lo, hi in ranges:
        assert hi > lo, "a program without columns"
        seen[m, lo:hi] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("k", [1, 2, 4])
def test_column_plan_is_balanced_on_132_sms(k):
    """All programs fit the planned programs per SM, with no SM short of
    one, and the busiest SM's columns exceed the even share K*D/132 by
    less than 16 columns per program; at full width a program's columns
    fit one tile."""
    per, span, _ = _ranges(k, FULL_D, H100_SMS)
    _, block_d, _, p_sm = dp_clip.mean_tile(k)
    n_prog = k * per
    assert (p_sm - 1) * H100_SMS < n_prog <= p_sm * H100_SMS
    assert p_sm * span - k * FULL_D / H100_SMS < p_sm * 16
    assert span <= block_d


@pytest.mark.parametrize("k,want", [(1, 1), (2, 2), (3, 4), (4, 4), (8, 4)])
def test_tile_depends_on_the_cohort_size_only(k, want):
    """The tile (and so each column's sum order) comes from K: a size
    between two listed takes the larger one's, above the last the last's;
    its rows and columns are powers of two, as Triton's tiles must be."""
    rows, block_d, warps, p_sm = dp_clip.mean_tile(k)
    assert (rows, block_d, warps, p_sm) == dp_clip.MEAN_TILES[want]
    for n in (rows, block_d, warps):
        assert n & (n - 1) == 0


def scale_mean_model(flat, scales, *, k, inv_b, n_sm):
    """The clipped-mean kernel's arithmetic under its plan: program p of
    member m owns columns [p * span, (p + 1) * span); each of them keeps
    ROWS partial sums, partial r taking rows r, r + ROWS, ... in order,
    and adds the partials at the end."""
    r_all, d = flat.shape
    b = r_all // k
    rows = dp_clip.mean_tile(k)[0]
    per, span = dp_clip.mean_plan(k, d, n_sm)
    out = torch.full((k, d), float("nan"))
    for m in range(k):
        g, s = flat[m * b:(m + 1) * b], scales[m * b:(m + 1) * b]
        for p in range(per):
            cols = slice(p * span, min((p + 1) * span, d))
            acc = torch.zeros(rows, cols.stop - cols.start)
            for row in range(b):
                acc[row % rows] = acc[row % rows] + s[row] * g[row, cols]
            total = acc[0]
            for r in range(1, rows):
                total = total + acc[r]
            out[m, cols] = total * inv_b
    return out


@pytest.mark.parametrize("k,b,d", [(2, 13, 1031), (1, 128, 4093),
                                   (4, 40, 600)])
def test_clipped_mean_order_does_not_depend_on_the_sm_count(k, b, d):
    rng = np.random.default_rng(k * 100 + b + d)
    g = (rng.standard_normal((k, b, d)) * 0.05).astype(np.float32)
    g[:, : (b + 1) // 2] *= 40.0
    flat = torch.from_numpy(g).view(k * b, d)
    norms = torch.sqrt(clip_ref.sqnorms_ref(flat))
    scales = clip_ref.clip_scales(norms, 1.0)
    outs = [scale_mean_model(flat, scales, k=k, inv_b=1.0 / b, n_sm=n)
            for n in SM_COUNTS]
    assert not torch.isnan(outs[0]).any()
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    want = clip_ref.cohort_scale_mean_ref(flat, scales, k=k, inv_b=1.0 / b)
    torch.testing.assert_close(outs[0], want, rtol=1e-6, atol=1e-6)
    jax_means = r_clip(jnp.asarray(g), 1.0)[0]
    np.testing.assert_allclose(outs[0].numpy(), np.asarray(jax_means),
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the norms pass: the split-D plan
# ---------------------------------------------------------------------------

# (R, D) of chip_smoke.py's phase_kernels: the main path's K*B = 128, 256
# and 512 rows at full D, then the awkward ones
NORM_SHAPES = [(128, FULL_D), (256, FULL_D), (512, FULL_D), (1, FULL_D),
               (39, 1031), (14, 37), (512, 4093)]


def _norm_ranges(d, n_splits, width):
    """Column range of each split, as ``_sqnorm_kernel`` computes it: the
    first n_narrow ranges take width - 16 columns, the rest width, the
    last cut at D."""
    n_narrow = n_splits * width // 16 - -(-d // 16)
    out = []
    for s in range(n_splits):
        lo = s * width - 16 * min(s, n_narrow)
        out.append((lo, min(lo + width - 16 * (s < n_narrow), d)))
    return out


@pytest.fixture
def fake_sm_count(monkeypatch, no_device):
    """Make every SM-count lookup answer ``n``; returns the setter."""
    from repro_torch.kernels import common

    def set_count(n):
        monkeypatch.setattr(common, "sm_count", lambda dev: n)
        monkeypatch.setattr(dp_clip, "sm_count", lambda dev: n)
    return set_count


@pytest.mark.parametrize("n_sm", SM_COUNTS)
@pytest.mark.parametrize("r,d", NORM_SHAPES, ids=str)
def test_norm_plan_covers_every_value_once(fake_sm_count, r, d, n_sm):
    """Every (row, column) is summed by exactly one program; the ranges
    are multiples of 16 columns wide (the last cut at D) and equal to
    within 16 columns; the plan is the same whatever the SM count."""
    fake_sm_count(n_sm)
    rows, n_splits, width = dp_clip.sqnorm_plan(r, d)
    assert all(type(v) is int for v in (rows, n_splits, width))
    assert width % 16 == 0 and rows & (rows - 1) == 0
    assert 1 <= n_splits <= dp_clip.SQNORM_MAX_SPLITS
    seen = np.zeros((r, d), np.int64)
    ranges = _norm_ranges(d, n_splits, width)
    for t in range(-(-r // rows)):
        for lo, hi in ranges:
            assert hi > lo, "a program without columns"
            seen[t * rows:(t + 1) * rows, lo:hi] += 1
    assert (seen == 1).all()
    widths = [hi - lo for lo, hi in ranges]
    assert all(w % 16 == 0 for w in widths[:-1])
    assert max(widths) - min(widths) <= 16
    fake_sm_count(SM_COUNTS[0])
    assert dp_clip.sqnorm_plan(r, d) == (rows, n_splits, width)


@pytest.mark.parametrize("r", [256, 512])
def test_norm_plan_is_balanced_on_132_sms(no_device, r):
    """At K = 2 and 4 (R = 256, 512) at full D: a whole number of
    programs per SM of an H100 SXM, between 8 and 20, every program with
    the same rows and the same columns to within 16, and a range several
    tiles long."""
    rows, n_splits, width = dp_clip.sqnorm_plan(r, FULL_D)
    n_prog = n_splits * -(-r // rows)
    assert n_prog % H100_SMS == 0
    assert 8 <= n_prog // H100_SMS <= 20
    assert r % rows == 0
    assert width >= 4 * dp_clip.sqnorm_block_d(rows, width)


def _tree_sum(v):
    """The in-tile reduction, modelled as halving: a fixed order for a
    fixed BLOCK_D (Triton's own tree is another fixed one)."""
    while v.shape[-1] > 1:
        half = v.shape[-1] // 2
        v = v[..., :half] + v[..., half:]
    return v[..., 0]


def sqnorm_model(flat):
    """The norms pass's arithmetic under its plan: per row tile and range,
    BLOCK_D lanes each summing their columns tile by tile in order, the
    lanes reduced in a fixed tree; then each row's partials added in split
    order."""
    r, d = flat.shape
    rows, n_splits, width = dp_clip.sqnorm_plan(r, d)
    block_d = dp_clip.sqnorm_block_d(rows, width)
    parts = []
    for lo, hi in _norm_ranges(d, n_splits, width):
        acc = torch.zeros(r, block_d)
        for c0 in range(lo, hi, block_d):
            x = torch.zeros(r, block_d)
            x[:, :min(block_d, hi - c0)] = flat[:, c0:min(c0 + block_d, hi)]
            acc = acc + x * x
        parts.append(_tree_sum(acc))
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


@pytest.mark.parametrize("r,d", [(39, 1031), (14, 37), (7, 4093),
                                 (2, 20011), (1, 600)], ids=str)
def test_norm_order_does_not_depend_on_the_sm_count(fake_sm_count, r, d):
    rng = np.random.default_rng(r * 1000 + d)
    g = (rng.standard_normal((r, d)) * 0.05).astype(np.float32)
    flat = torch.from_numpy(g)
    outs = []
    for n_sm in SM_COUNTS:
        fake_sm_count(n_sm)
        outs.append(sqnorm_model(flat))
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    torch.testing.assert_close(outs[0], clip_ref.sqnorms_ref(flat),
                               rtol=1e-6, atol=0)
    jax_norms = jax.vmap(lambda row: r_clip_flat(row[None], 1.0)[1])(
        jnp.asarray(g))
    np.testing.assert_allclose(outs[0].numpy(),
                               np.square(np.asarray(jax_norms)), rtol=1e-6)


# ---------------------------------------------------------------------------
# ssd_intra_chunk: the tensor-core kernel's tile arithmetic
# ---------------------------------------------------------------------------

# (b, c, q, h, p, n): chip_smoke.py's SSD_SHAPES with the full-width one
# cut from b * c = 128 chunks to 2 (its widths kept), then the ragged ones
SSD_TC_SHAPES = [(1, 2, 128, 64, 64, 64), (1, 2, 32, 2, 16, 16),
                 (2, 4, 64, 4, 64, 64), (1, 1, 128, 8, 64, 32),
                 (1, 1, 20, 2, 16, 12), (2, 3, 36, 3, 24, 40),
                 (1, 2, 64, 2, 128, 160)]
LOG2E = 1.4426950408889634


def ssd_tc_model(xr, ar, Br, Cr):
    """The bf16 kernel's arithmetic: q padded to 16-row blocks with zeros;
    S = C.B^T in f32; on the causal lower triangle, masked BEFORE exp, the
    decay exp2(cs_i - cs_j) with cs the cumsum of a in log2 units; the
    decayed scores rounded to bf16; y_i summed over the key blocks j in
    order in f32, then rounded to bf16."""
    b, c, q, h, p = xr.shape
    qp = -(-q // 16) * 16
    pad = qp - q
    x = torch.nn.functional.pad(xr.float(), (0, 0, 0, 0, 0, pad))
    B = torch.nn.functional.pad(Br.float(), (0, 0, 0, pad))
    C = torch.nn.functional.pad(Cr.float(), (0, 0, 0, pad))
    cs = torch.cumsum(torch.nn.functional.pad(ar, (0, pad)), -1)
    cs = (cs * np.float32(LOG2E)).permute(0, 2, 1, 3)          # (b,c,h,qp)
    S = torch.matmul(C, B.transpose(-1, -2))[:, :, None]       # (b,c,1,i,j)
    d = cs[..., :, None] - cs[..., None, :]                   # (b,c,h,i,j)
    mask = torch.tril(torch.ones(qp, qp, dtype=torch.bool))
    w = torch.where(mask, S * torch.exp2(torch.where(mask, d, 0.0)), 0.0)
    P = w.to(torch.bfloat16).float()
    xh = x.permute(0, 1, 3, 2, 4)                              # (b,c,h,j,p)
    y = torch.zeros(b, c, h, qp, p)
    for jb in range(0, qp, 16):
        y = y + torch.matmul(P[..., jb:jb + 16], xh[..., jb:jb + 16, :])
    return y.permute(0, 1, 3, 2, 4)[:, :, :q].to(torch.bfloat16)


@pytest.mark.parametrize("shape", SSD_TC_SHAPES, ids=str)
def test_ssd_tensor_core_model_matches_jax_oracle_bf16(shape):
    b, c, q, h, p, n = shape
    rng = np.random.default_rng(q * 100 + n)
    xr = rng.standard_normal((b, c, q, h, p)).astype(np.float32)
    ar = (-rng.random((b, h, c, q)) * 0.2).astype(np.float32)
    Br = rng.standard_normal((b, c, q, n)).astype(np.float32)
    Cr = rng.standard_normal((b, c, q, n)).astype(np.float32)
    tx, tB, tC = (torch.from_numpy(v).to(torch.bfloat16)
                  for v in (xr, Br, Cr))
    got = ssd_tc_model(tx, torch.from_numpy(ar), tB, tC)
    assert got.dtype == torch.bfloat16 and got.shape == tx.shape
    bf = jnp.bfloat16
    want = np.asarray(r_ssd_ref(jnp.asarray(xr).astype(bf), jnp.asarray(ar),
                                jnp.asarray(Br).astype(bf),
                                jnp.asarray(Cr).astype(bf)), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=5e-2,
                               atol=1e-2 * float(np.abs(want).max()))
    plain = ssd_intra_chunk_ref(tx, torch.from_numpy(ar), tB, tC)
    torch.testing.assert_close(got.float(), plain, rtol=5e-2,
                               atol=1e-2 * float(plain.abs().max()))
