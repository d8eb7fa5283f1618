"""The tensor-core jvp of the windowed attention, on the CPU.

``csrc/swa_attention_bwd_sm90.cu``'s jvp kernel runs only on a card; its
design is checked here by emulating its numerics in f32 on bf16 storage,
tile by tile on the forward's geometry (``swa_attention.swa_geometry``:
each query tile walks its band in key tiles of 64, of 32 at hd_pad 256):

* pass 1: S = q.k and ds = tq.k + q.tk in f32, the online softmax's max,
  sum and dsum = sum_j exp(scale S - m) scale ds a key tile at a time,
  giving each row's LSE and dsbar = dsum / l;
* pass 2: S and ds again, P = exp(scale S - LSE) (masked pairs 0) and X
  = P (scale ds - dsbar), each split into bf16 hi + lo before its product
  (X with V, P with TV) and the products summed in f32 into one
  accumulator, rounded to bf16 at the end.

Held against ``jax.jvp`` of ``repro.models.layers.windowed_attention`` in
f32 on the same numpy-seeded inputs (bf16 values; relative L2 1e-5 before
the final rounding), and against the plain version ``kernels.ref.
swa_attention_jvp_ref`` under the card's rule (chip_smoke.py phase 13):
relative L2 from the f32 plain result no more than 1.5 x the bf16 plain
result's, + 1e-6.  Window 0 gives tv's bits.  At recurrentgemma-9b's and
mixtral-8x22b's head geometry the split uses about two thirds of that
limit and a single bf16 rounding of X and P nearly all of it (the numbers
are asserted below), so the kernel keeps the split.  Also the ring's
schedule: every wait for a tile comes after the frees it needs.  The card
holds the kernel itself to the same rule (``tests/
test_torch_cuda_swa_train.py``, ``chip_smoke.py``).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.kernels import swa_attention as SWA  # noqa: E402

BF16_FACTOR = 1.5
BF16_FLOOR = 1e-6
F32_REL_L2 = 1e-5
NEG = -1e30


def _key_tile(hd_pad: int) -> int:
    """Keys of the jvp kernel's walked tile (its ``jvp_keys``)."""
    return 32 if hd_pad == 256 else SWA.KEY_TILE


# (B, T, H, K, hd, window): G = H // K of 1, 2, 6, 16 and 130 (one query x
# 128 heads a tile, two head tiles), K of 1 and 2, ragged T (1, 65, 200),
# window 0, inside T and past T; hd 32 (64-key tiles) and, for the
# 32-key walk, hd 136 (hd_pad 256) at G = 2 and 16
_GROUPS = [(G, K) for G in (1, 2, 6, 16, 130) for K in (1, 2)]
_SHAPES = [(1, T, G * K, K, 32, w) for G, K in _GROUPS
           for T in (1, 65, 200) for w in (0, 70, T + 7)]
_SHAPES += [(1, 200, G, 1, 136, w) for G in (2, 16) for w in (0, 70, 207)]
# one JAX case a (G, K), T and window rotating, and one at hd_pad 256
_JAX_SHAPES = [(1, (65, 200)[i % 2], G * K, K, 32,
                (0, 70, (65, 200)[i % 2] + 7)[i % 3])
               for i, (G, K) in enumerate(_GROUPS)]
_JAX_SHAPES += [(1, 200, 16, 2, 136, 70)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """PyTorch on one thread for this module: its emulated tiles are small
    tensor ops, and beside the suite's parallel workers the default
    thread pool oversubscribes the cores and multiplies the file's time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, T, H, K, hd, seed):
    """q, k, v, tq, tk, tv as bf16 tensors from a numpy normal draw."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(B, T, h, hd))
                             .astype(np.float32)).to(torch.bfloat16)
            for h in (H, K, K, H, K, K)]


def _jvp_emulation(q, k, v, tq, tk, tv, window, *, split=True):
    """The jvp kernel's arithmetic in f32 on bf16 storage, a query tile of
    ``swa_geometry`` and a key tile (``_key_tile``) at a time: (f32
    accumulator, its bf16 rounding), each (B, T, H, hd).  ``split=False``
    rounds X and P to bf16 once instead of splitting them.

    Every query tile runs at once: tile x's j-th key tile starts at its
    first key + j key tiles (``key_span``), and a tile past a query
    tile's span is wholly outside its band, so it leaves the online
    softmax's m, l and dsum and the accumulator exactly as they were."""
    B, T, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    geo = SWA.swa_geometry(B, T, H, K, hd, window)
    scale = 1.0 / math.sqrt(hd)
    X, Q, kt = geo.grid[0], geo.queries, _key_tile(geo.hd_pad)
    pad = X * Q - T

    def tiles(x):               # (B, X, Q, K, G, hd), rows past T zero
        x = torch.nn.functional.pad(x.float().reshape(B, T, K, G, hd),
                                    (0, 0, 0, 0, 0, 0, 0, pad))
        return x.reshape(B, X, Q, K, G, hd)

    qf, tqf = tiles(q), tiles(tq)
    t0 = torch.arange(X) * Q
    first = torch.clamp(t0 - geo.window, min=0)
    n_tiles = -(-(torch.clamp(t0 + Q, max=T) - first) // kt)
    keys = (first[:, None, None] + torch.arange(int(n_tiles.max()))[:, None]
            * kt + torch.arange(kt))                       # (X, J, kt)
    rows = t0[:, None] + torch.arange(Q)                   # (X, Q)
    # (X, J, Q, kt): the band, tile by tile
    band = ((keys[:, :, None, :] <= rows[:, None, :, None])
            & (keys[:, :, None, :] >= rows[:, None, :, None] - geo.window))
    band = band[None, :, :, None, None]                    # (1,X,J,1,1,Q,kt)
    at = torch.clamp(keys, max=T - 1)
    kf, tkf, vf, tvf = (x.float()[:, at] for x in (k, tk, v, tv))
    s = torch.einsum("bxtkgd,bxjskd->bxjkgts", qf, kf)
    ds = (torch.einsum("bxtkgd,bxjskd->bxjkgts", tqf, kf)
          + torch.einsum("bxtkgd,bxjskd->bxjkgts", qf, tkf))
    J = keys.shape[1]
    # pass 1: each row's LSE and dsbar
    m = torch.full((B, X, K, G, Q), NEG)
    l = torch.zeros_like(m)
    dsum = torch.zeros_like(m)
    for j in range(J):
        bj = band[:, :, j]
        sc = torch.where(bj, s[:, :, j] * scale, NEG)
        mn = torch.maximum(m, sc.amax(-1))
        e = torch.where(bj, torch.exp(sc - mn[..., None]), 0.0)
        corr = torch.exp(m - mn)
        l = l * corr + e.sum(-1)
        dsum = dsum * corr + (e * (ds[:, :, j] * scale)).sum(-1)
        m = mn
    safe = torch.clamp(l, min=1e-30)
    lse = (m + torch.log(safe))[..., None]
    dsbar = (dsum / safe)[..., None]

    def parts(x):
        hi = x.to(torch.bfloat16).float()
        return (hi, (x - hi).to(torch.bfloat16).float()) if split else (hi,)

    # pass 2: tout = sum_j X V + sum_j P TV
    acc = torch.zeros(B, X, Q, K, G, hd)
    for j in range(J):
        bj = band[:, :, j]
        p = torch.where(bj, torch.exp(s[:, :, j] * scale - lse), 0.0)
        xx = torch.where(bj, p * (ds[:, :, j] * scale - dsbar), 0.0)
        for a in parts(xx):
            acc += torch.einsum("bxkgts,bxskd->bxtkgd", a, vf[:, :, j])
        for a in parts(p):
            acc += torch.einsum("bxkgts,bxskd->bxtkgd", a, tvf[:, :, j])
    out = acc.reshape(B, X * Q, H, hd)[:, :T]
    return out, out.to(torch.bfloat16)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    num, den = np.linalg.norm(a - b), np.linalg.norm(b)
    return float(num / den) if den > 0 else (0.0 if num == 0 else math.inf)


def _np(t):
    return t.float().numpy()


def _plain(xs, window):
    """(plain version in bf16, plain version on the inputs in f32)."""
    return (TR.swa_attention_jvp_ref(*xs, window),
            TR.swa_attention_jvp_ref(*(x.float() for x in xs), window))


@pytest.mark.parametrize("B,T,H,K,hd,window", _SHAPES)
def test_emulated_kernel_meets_the_bf16_rule(B, T, H, K, hd, window):
    xs = _inputs(B, T, H, K, hd, seed=T + H + window)
    _, got = _jvp_emulation(*xs, window)
    plain, plain32 = _plain(xs, window)
    assert got.shape == plain.shape and bool(torch.isfinite(got).all())
    limit = BF16_FACTOR * _rel_l2(_np(plain), _np(plain32)) + BF16_FLOOR
    assert _rel_l2(_np(got), _np(plain32)) <= limit
    if window == 0:
        # P = 1 and X = 0 exactly: tout is tv's bits
        assert torch.equal(got, xs[5].repeat_interleave(H // K, dim=2))


@pytest.mark.parametrize("B,T,H,K,hd,window", _JAX_SHAPES)
def test_emulated_kernel_matches_jax_jvp(B, T, H, K, hd, window):
    """Before its final rounding the emulated kernel is the f32 jvp of the
    reference's windowed_attention on the same (bf16-valued) inputs."""
    xs = _inputs(B, T, H, K, hd, seed=3 * T + H + window)
    acc, _ = _jvp_emulation(*xs, window)
    a = [_np(x) for x in xs]

    def f(q, k, v):
        return JL.windowed_attention(q, k, v, window, q_chunk=T)

    want = jax.jit(lambda *z: jax.jvp(f, z[:3], z[3:])[1])(*a)
    assert _rel_l2(acc.numpy(), np.asarray(want)) <= F32_REL_L2


def _ring_order(n_tiles: int) -> tuple:
    """The producer's items (pass, tensor, tile) in load order, and each
    consumer's operations ("wait" or "free", item) in program order."""
    items = [(1, x, j) for j in range(n_tiles) for x in ("K", "TK")]
    items += [(2, x, j) for j in range(n_tiles)
              for x in ("K", "TK", "V", "TV")]
    ops = []
    for j in range(n_tiles):
        i = 2 * j
        ops += [("wait", i), ("wait", i + 1), ("free", i), ("free", i + 1)]
    for j in range(n_tiles):
        i = 2 * n_tiles + 4 * j
        ops += [("wait", i), ("wait", i + 1), ("free", i), ("free", i + 1),
                ("wait", i + 2), ("free", i + 2), ("wait", i + 3),
                ("free", i + 3)]
    return items, ops


@pytest.mark.parametrize("slots", [3, 6, 8])
@pytest.mark.parametrize("n_tiles", [1, 2, 5, 34])
def test_ring_waits_only_on_loads_its_frees_allow(n_tiles, slots):
    """Item i goes into slot i % slots once item i - slots is freed; so no
    wait may come before the consumer freed every item up to i - slots
    (slots: the jvp's 8, 6 and 6 at hd_pad 64, 128 and 256; 3, the fewest
    this order takes).  Each
    item is waited for and freed exactly once, after its wait, and each
    pass-2 tile reads K, TK, V and TV of that tile in that order."""
    items, ops = _ring_order(n_tiles)
    freed = set()
    for op, i in ops:
        if op == "wait":
            assert all(f in freed for f in range(i - slots + 1)), (i, slots)
            assert i not in freed
        else:
            freed.add(i)
    assert sorted(i for op, i in ops if op == "wait") == list(range(
        len(items)))
    assert freed == set(range(len(items)))
    waits = [items[i] for op, i in ops if op == "wait"]
    assert waits[2 * n_tiles:] == [(2, x, j) for j in range(n_tiles)
                                   for x in ("K", "TK", "V", "TV")]


# recurrentgemma-9b's and mixtral-8x22b's head geometry (G = 16, hd 256;
# G = 6, hd 128) at T 512, the band crossing several key tiles
_NUMERIC_SHAPES = [(1, 512, 16, 1, 256, 128), (1, 512, 12, 2, 128, 200)]


@pytest.mark.parametrize("B,T,H,K,hd,window", _NUMERIC_SHAPES)
def test_split_keeps_the_plain_rounding_and_single_rounding_does_not(
        B, T, H, K, hd, window):
    xs = _inputs(B, T, H, K, hd, seed=T + hd)
    plain, plain32 = _plain(xs, window)
    base = _rel_l2(_np(plain), _np(plain32))
    limit = BF16_FACTOR * base + BF16_FLOOR
    split = _rel_l2(_np(_jvp_emulation(*xs, window)[1]), _np(plain32))
    single = _rel_l2(_np(_jvp_emulation(*xs, window, split=False)[1]),
                     _np(plain32))
    print(f"(B,T,H,K,hd,window)={(B, T, H, K, hd, window)}: limit "
          f"{limit:.4g}; split {split:.4g} ({split / limit:.1%}), single "
          f"bf16 rounding {single:.4g} ({single / limit:.1%})")
    # the split's own error is far below the output's rounding
    assert split <= 1.05 * base
    assert split <= 0.7 * limit
    # single rounding adds an error of the output rounding's size
    assert single > 0.85 * limit
