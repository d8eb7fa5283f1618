"""The tensor-core sliding-window attention kernel's design, on the CPU.

``csrc/swa_attention_sm90.cu`` runs only on a card; what surrounds it is
checked here:

* ``swa_geometry`` (the launch geometry the wrapper hands the kernel):
  every (batch, query, head) is a valid row of exactly one tile, and each
  tile's key span covers [t - window, t] of each of its rows without a
  wholly empty key tile, over G = H // K of 1, 2, 3, 16 and 130, ragged T,
  window 0 and past T, and the prefill shapes of recurrentgemma-9b and
  mixtral-8x22b (G = 6: 21 queries x 6 heads fill 126 of 128 rows);
* the split-P numerics: O = (P_hi.V + P_lo.V) / l with P_hi = bf16(P) and
  P_lo = bf16(P - P_hi), emulated in f32 at bf16 storage, against the
  plain version ``kernels.ref.swa_attention_ref`` at (B, T, H, K, hd,
  window) = (1, 1024, 16, 1, 256, 256), under the card's checks: |d| <=
  1e-4 + 2^-7 |plain| (one bf16 ulp) and at most 1 % of the bf16 entries
  differing; rounding P to bf16 alone fails that share.  The card holds
  the kernel itself to the same checks (``tests/test_torch_cuda_lm.py``,
  ``chip_smoke.py``).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.kernels import swa_attention as SWA  # noqa: E402

SWA_TOL = (1e-4, 2.0 ** -7)
SWA_BF16_DIFF_SHARE = 0.01

_SHAPES = [(B, T, G * K, K, (64, 80, 128, 256)[i % 4], w)
           for i, (B, K, G, T) in enumerate(
               (B, K, G, T) for B, K in ((1, 1), (2, 2))
               for G in (1, 2, 3, 16) for T in (1, 7, 8, 9, 4100))
           for w in (0, T + 5)]
_PREFILL = (2, 32768, 16, 1, 256, 2048)
_MIXTRAL_PREFILL = (1, 32768, 48, 8, 128, 4096)


def _coverage(B, T, H, K, hd, window):
    geo = SWA.swa_geometry(B, T, H, K, hd, window)
    G = H // K
    assert geo.rows == SWA.ROWS == 128
    assert geo.heads == min(G, 128) and geo.queries == 128 // geo.heads
    assert geo.queries * geo.heads <= geo.rows
    assert geo.hd_pad in (64, 128, 256) and 0 <= geo.hd_pad - hd < 64
    assert geo.grid == (-(-T // geo.queries), K * geo.head_tiles, B)
    assert geo.window == min(window, T)
    hits = torch.zeros(T, H, dtype=torch.int64)
    for x in range(geo.grid[0]):
        first, n_tiles = geo.key_span(x)
        for y in range(geo.grid[1]):
            t, head, valid = geo.tile_rows(x, y)
            t, head = t[valid], head[valid]
            assert len(t) > 0
            # every row of the tile reads kv head y // head_tiles
            assert bool((head // G == y // geo.head_tiles).all())
            hits.index_put_((t, head), torch.ones_like(t), accumulate=True)
            lo = (t - window).clamp(min=0)
            assert first <= int(lo.min())
            assert first == max(0, int(t.min()) - geo.window)
            assert first + n_tiles * SWA.KEY_TILE - 1 >= int(t.max())
            # no key tile lies wholly past the last query
            assert first + (n_tiles - 1) * SWA.KEY_TILE <= int(t.max())
    # the same tiles for every batch row z: each (query, head) once
    assert bool((hits == 1).all()), (
        f"{int((hits == 0).sum())} rows uncovered, "
        f"{int((hits > 1).sum())} covered twice")
    return geo


@pytest.mark.parametrize("B,T,H,K,hd,window", _SHAPES)
def test_geometry_covers_every_row_once_with_its_keys(B, T, H, K, hd,
                                                      window):
    _coverage(B, T, H, K, hd, window)


def test_geometry_of_the_prefill_shape():
    geo = _coverage(*_PREFILL)
    # 8 queries x 16 heads, one K/V span of window + 8 keys for 16 heads
    assert (geo.queries, geo.heads, geo.head_tiles, geo.hd_pad) == \
        (8, 16, 1, 256)
    assert geo.grid == (4096, 1, 2)
    assert geo.key_span(4095) == (32760 - 2048, 33)


def test_geometry_of_the_mixtral_prefill_shape():
    geo = _coverage(*_MIXTRAL_PREFILL)
    # 21 queries x 6 heads (two rows masked), one tile per kv head
    assert (geo.queries, geo.heads, geo.head_tiles, geo.hd_pad) == \
        (21, 6, 1, 128)
    assert geo.grid == (1561, 8, 1)
    # the last tile: queries 32760..32767, keys from 32760 - 4096
    assert geo.key_span(1560) == (32760 - 4096, 65)


@pytest.mark.parametrize("H,K,queries,heads,head_tiles", [
    (4, 4, 128, 1, 1),          # MHA: 128 queries of one head
    (6, 2, 42, 3, 1),           # G = 3: 126 rows, two masked
    (130, 1, 1, 128, 2),        # G > 128: the heads tiled
])
def test_geometry_of_odd_groups(H, K, queries, heads, head_tiles):
    geo = _coverage(1, 50, H, K, 64, 7)
    assert (geo.queries, geo.heads, geo.head_tiles) == (queries, heads,
                                                        head_tiles)


def _bf16_inputs(B, T, H, K, hd, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(B, T, h, hd))
                             .astype(np.float32)).to(torch.bfloat16)
            for h in (H, K, K)]


def _split_p_emulation(q, k, v, window, *, split=True):
    """The tensor-core kernel's arithmetic in f32 at bf16 storage, one
    pass over all keys: S = q.k scaled in f32, P = exp(S - max) of the
    valid keys, l = sum P in f32, O = (P_hi.V + P_lo.V) / max(l, 1e-30)
    rounded to bf16 (``split=False``: P_hi.V alone, the control)."""
    B, T, H, hd = q.shape
    K = k.shape[2]
    qf = q.float().reshape(B, T, K, H // K, hd)
    s = torch.einsum("btkgd,bskd->bkgts", qf, k.float()) \
        * (1.0 / math.sqrt(hd))
    pos = torch.arange(T)
    valid = (pos[None, :] <= pos[:, None]) \
        & (pos[None, :] >= pos[:, None] - window)
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    p = torch.where(valid, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = p.sum(-1, keepdim=True).clamp(min=1e-30)
    p_hi = p.to(torch.bfloat16).float()
    o = torch.einsum("bkgts,bskd->bkgtd", p_hi, v.float())
    if split:
        p_lo = (p - p_hi).to(torch.bfloat16).float()
        o = o + torch.einsum("bkgts,bskd->bkgtd", p_lo, v.float())
    o = o / l
    return o.permute(0, 3, 1, 2, 4).reshape(B, T, H, hd).to(torch.bfloat16)


def _share(got, want):
    return float((got != want).float().mean())


def test_split_p_keeps_f32_accuracy_and_bf16_p_does_not():
    q, k, v = _bf16_inputs(1, 1024, 16, 1, 256, seed=14)
    window = 256
    want = TR.swa_attention_ref(q, k, v, window)
    got = _split_p_emulation(q, k, v, window)
    atol, rtol = SWA_TOL
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= atol + rtol * want.float().abs()).all()), \
        float(diff.max())
    assert _share(got, want) <= SWA_BF16_DIFF_SHARE
    ctl = _split_p_emulation(q, k, v, window, split=False)
    assert _share(ctl, want) > SWA_BF16_DIFF_SHARE
