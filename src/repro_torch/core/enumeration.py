"""Fischer enumeration of the pyramid surface P(N, K)  (paper §II, §VI).

Provides:
  * ``num_points(N, K)``  — the exact number of lattice points N_p(N, K)
    (Python bigints; the paper notes these get thousands of bits long).
  * ``index_bits(N, K)``  — ceil(log2(N_p)), the fixed-size code length.
  * ``vector_to_index`` / ``index_to_vector`` — the bijection between points
    of P(N, K) and integers [0, N_p), via lexicographic ranking with the
    per-coordinate value order 0, +1, -1, +2, -2, ...  O(N*K) bigint ops —
    kept as the exact reference implementation.
  * ``vector_to_index_batch`` / ``index_to_vector_batch`` — the same
    bijection as vectorized limb arithmetic: ranks are little-endian
    uint32 limb arrays and all groups of a leaf advance one coordinate per
    numpy round, so enumeration coding is fast enough to be the default
    ``.pvqz`` codec (no bigint in the per-group path).

Recurrence (Fischer 1986):
    N_p(L, K) = N_p(L-1, K) + N_p(L-1, K-1) + N_p(L, K-1)
    N_p(L, 0) = 1,   N_p(0, K) = 0 for K > 0
Closed form: N_p(N, K) = sum_d 2^d C(N, d) C(K-1, d-1).

The PyTorch port's copy of ``repro.core.enumeration``: numpy only, the same
bits on the same inputs.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Iterable, List, Sequence, Tuple

import numpy as np

_LIMB_BITS = 32
_LIMB_MASK = (1 << _LIMB_BITS) - 1

#: Per-(n, k_max) cumulative count tables are materialized once and cached;
#: this caps their footprint so a pathological leaf shape cannot OOM the
#: encoder.  It is a table-memory bound, not an encode-cost gate: every
#: realistic group size (<= 1024 dims) fits with orders of magnitude to spare.
ENUM_TABLE_MAX_BYTES = 256 * 2**20


@lru_cache(maxsize=None)
def num_points(n: int, k: int) -> int:
    """N_p(n, k): number of integer vectors of dim n with L1 norm exactly k."""
    if k == 0:
        return 1
    if n == 0:
        return 0
    # Closed form with bigints — O(min(n,k)) terms, no deep recursion.
    total = 0
    for d in range(1, min(n, k) + 1):
        total += (1 << d) * math.comb(n, d) * math.comb(k - 1, d - 1)
    return total


def index_bits(n: int, k: int) -> int:
    """Bits for a fixed-length enumeration code of P(n, k) (paper: N_p(8,4)=2816 -> <12 bits)."""
    points = num_points(n, k)
    return max((points - 1).bit_length(), 1)


def _value_order(k: int) -> List[int]:
    """Per-coordinate value order: 0, +1, -1, +2, -2, ... +k, -k."""
    order = [0]
    for m in range(1, k + 1):
        order.extend((m, -m))
    return order


def vector_to_index(y: Sequence[int]) -> int:
    """Rank a point of P(N, K) lexicographically (value order above)."""
    y = [int(v) for v in y]
    k = sum(abs(v) for v in y)
    n = len(y)
    idx = 0
    for pos, v in enumerate(y):
        rem_dims = n - pos - 1
        for u in _value_order(k):
            if u == v:
                break
            idx += num_points(rem_dims, k - abs(u))
        k -= abs(v)
    return idx


def index_to_vector(idx: int, n: int, k: int) -> List[int]:
    """Inverse of :func:`vector_to_index`."""
    if not (0 <= idx < num_points(n, k)):
        raise ValueError(f"index {idx} out of range for P({n},{k})")
    out: List[int] = []
    for pos in range(n):
        rem_dims = n - pos - 1
        for u in _value_order(k):
            cnt = num_points(rem_dims, k - abs(u))
            if idx < cnt:
                out.append(u)
                k -= abs(u)
                break
            idx -= cnt
        else:  # pragma: no cover - unreachable for valid idx
            raise AssertionError("enumeration overflow")
    assert k == 0
    return out


def enumerate_all(n: int, k: int) -> Iterable[List[int]]:
    """Yield every point of P(n, k) in rank order (test utility; small n,k only)."""
    for i in range(num_points(n, k)):
        yield index_to_vector(i, n, k)


def pack_indices(vectors: np.ndarray) -> bytes:
    """Fixed-length bit-packing of a batch of P(N,K) points via enumeration.

    vectors: int array (G, N), each row on P(N, K_row) with a shared K
    (rows may use fewer pulses only if they are exact zeros => K=0 rows get
    index 0 of P(N,0)={0}).  Returns the concatenated bitstream.
    """
    vectors = np.asarray(vectors)
    g, n = vectors.shape
    k = int(np.abs(vectors).sum(axis=-1).max()) if vectors.size else 0
    nbits = index_bits(n, k)
    acc = 0
    for row in vectors:
        acc = (acc << nbits) | vector_to_index(row.tolist())
    total_bits = nbits * g
    nbytes = (total_bits + 7) // 8
    return acc.to_bytes(nbytes, "big") if nbytes else b""


def unpack_indices(blob: bytes, g: int, n: int, k: int) -> np.ndarray:
    nbits = index_bits(n, k)
    acc = int.from_bytes(blob, "big")
    rows = []
    for i in range(g):
        shift = nbits * (g - 1 - i)
        idx = (acc >> shift) & ((1 << nbits) - 1)
        rows.append(index_to_vector(idx, n, k))
    return np.asarray(rows, dtype=np.int64)


# ---------------------------------------------------------------------------
# Vectorized limb-bignum enumeration (the fast path behind the `enum` codec).
#
# A rank of P(n, k) needs up to index_bits(n, k) bits — far beyond int64 for
# real group sizes — so ranks are fixed-width little-endian uint32 limb
# arrays of shape (G, L).  The per-coordinate ladder of the reference
# implementation becomes gathers into two precomputed tables:
#
#   NP[rem, t] = N_p(rem, t)                       (rem = dims after this one)
#   DP[rem, t] = sum_{j < t} N_p(rem, j)           (exclusive prefix over t)
#
# both stored as limb arrays, so one encode round sums, over all groups at
# once, the lexicographic skip-count of the chosen value v (|v| = m > 0):
#
#   inc = NP[rem, k] + 2*(DP[rem, k] - DP[rem, k-m+1]) + (v < 0)*NP[rem, k-m]
#
# (the v=0 subtree, both signs of every smaller magnitude, and +m if v is
# negative).  Decode inverts this with a v==0 test over all groups followed
# by a magnitude scan over the shrinking nonzero subset.  Limb intermediates
# use int64: |term| < 4*2^32 and n <= 4096 keeps accumulated sums < 2^46,
# and comparisons only ever subtract two carry-normalized operands, so the
# sign of the most significant nonzero limb difference is the sign of the
# difference.
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def limb_count(n: int, k_max: int) -> int:
    """uint32 limbs needed to hold any rank (or cumulative count) of P(n, k<=k_max)."""
    return max(1, (num_points(n, k_max).bit_length() + _LIMB_BITS - 1) // _LIMB_BITS)


def enum_table_bytes(n: int, k_max: int) -> int:
    """Footprint of the cached NP/DP limb tables for (n, k_max)."""
    if n <= 0:
        return 0
    return 8 * limb_count(n, k_max) * (n + 1) * (2 * k_max + 3)


def enum_supported(n: int, k_max: int) -> bool:
    """Whether the limb tables for (n, k_max) fit under ENUM_TABLE_MAX_BYTES.

    Also bounds the rank width at 29 limbs (928 bits) so every decode-side
    float64 proxy — value 1 at the widest per-position scale up to the top
    limb's weight — stays inside the normal float range.
    """
    return (
        n > 0
        and k_max >= 0
        and enum_table_bytes(n, k_max) <= ENUM_TABLE_MAX_BYTES
        and limb_count(n, k_max) <= 29
    )


@lru_cache(maxsize=8)
def enum_tables(n: int, k_max: int) -> Tuple[np.ndarray, np.ndarray]:
    """(NP, DP) limb tables as int64 limbs in [0, 2^32).

    NP has shape (n+1, k_max+1, L): NP[rem, t] = N_p(rem, t) for rem in
    [0, n] (the extra row n exists because NP[rem, k] + 2*DP[rem, k] ==
    N_p(rem+1, k), which the encoder exploits as a single gather).
    DP has shape (n, k_max+2, L): DP[rem, t] = sum_{j < t} N_p(rem, j).
    """
    if n <= 0 or k_max < 0:
        raise ValueError(f"invalid enumeration table shape ({n}, {k_max})")
    if not enum_supported(n, k_max):
        raise ValueError(
            f"enum tables for (n={n}, k_max={k_max}) would need "
            f"{enum_table_bytes(n, k_max)} bytes > ENUM_TABLE_MAX_BYTES"
        )
    L = limb_count(n, k_max)
    # Bigint rows via the Fischer recurrence (O(n*k) adds — far cheaper than
    # the closed form per entry), then one bulk little-endian conversion.
    rows: List[List[int]] = [[1] + [0] * k_max]
    for _ in range(n):
        prev = rows[-1]
        new = [1] + [0] * k_max
        for t in range(1, k_max + 1):
            new[t] = prev[t] + prev[t - 1] + new[t - 1]
        rows.append(new)
    width = 4 * L
    np_buf = b"".join(v.to_bytes(width, "little") for row in rows for v in row)
    NP = (
        np.frombuffer(np_buf, dtype=np.uint32)
        .reshape(n + 1, k_max + 1, L)
        .astype(np.int64)
    )
    dp_chunks: List[bytes] = []
    for row in rows[:n]:
        acc = 0
        parts = [b"\0" * width]
        for v in row:
            acc += v
            parts.append(acc.to_bytes(width, "little"))
        dp_chunks.append(b"".join(parts))
    DP = (
        np.frombuffer(b"".join(dp_chunks), dtype=np.uint32)
        .reshape(n, k_max + 2, L)
        .astype(np.int64)
    )
    return NP, DP


def _carry_norm(acc: np.ndarray) -> np.ndarray:
    """Normalize int64 limbs (possibly mixed-sign) to [0, 2^32); value must fit."""
    for _ in range(4 * acc.shape[-1] + 8):
        carry = acc >> _LIMB_BITS  # arithmetic shift == floor division
        if not carry.any():
            return acc
        acc &= _LIMB_MASK
        acc[..., 1:] += carry[..., :-1]
    if (acc >> _LIMB_BITS).any():  # pragma: no cover - guarded by callers
        raise AssertionError("limb accumulator failed to normalize")
    return acc


def vector_to_index_batch(groups: np.ndarray, k_max: int) -> np.ndarray:
    """Rank every row of ``groups`` on P(n, k_row); returns (G, L) uint32 limbs.

    Bit-identical to ``vector_to_index`` per row (property-tested); rows may
    carry any L1 norm k_row <= k_max, including 0.  Only nonzero coordinates
    contribute skip counts, so the gathers run over the nonzero set and the
    per-group rank is a ``reduceat`` segment sum.
    """
    groups = np.ascontiguousarray(np.asarray(groups, dtype=np.int64))
    if groups.ndim != 2:
        raise ValueError(f"expected (G, n) groups, got shape {groups.shape}")
    g, n = groups.shape
    k_max = int(k_max)
    NP, DP = enum_tables(n, k_max)
    L = NP.shape[-1]
    out = np.zeros((g, L), dtype=np.uint32)
    if g == 0:
        return out
    m_all = np.abs(groups)
    k_g = m_all.sum(axis=-1)
    if int(k_g.max(initial=0)) > k_max:
        raise ValueError(f"group L1 {int(k_g.max())} exceeds k_max {k_max}")
    gi, pi = np.nonzero(m_all)  # row-major: coordinates stay grouped by row
    if gi.size == 0:
        return out
    m = m_all[gi, pi]
    k_rem = k_g[gi] - np.cumsum(m_all, axis=1)[gi, pi] + m  # L1 left to spend
    rem = n - 1 - pi
    NPf = NP.reshape(-1, L)
    DPf = DP.reshape(-1, L)
    base = rem * (k_max + 1)
    # skip(v) = N_p(rem, k) + 2*(DP[rem, k] - DP[rem, k-m+1]) + (v<0)*N_p(rem, k-m)
    # and N_p(rem, k) + 2*DP[rem, k] == N_p(rem+1, k): one gather for two terms.
    term = NPf[base + (k_max + 1) + k_rem].copy()
    term -= 2 * DPf[rem * (k_max + 2) + k_rem - m + 1]
    neg = np.flatnonzero(groups[gi, pi] < 0)
    if neg.size:
        term[neg] += NPf[base[neg] + k_rem[neg] - m[neg]]
    cnt = (m_all > 0).sum(axis=1)
    nz_rows = np.flatnonzero(cnt)
    starts = np.cumsum(cnt[nz_rows]) - cnt[nz_rows]
    # |term limb| < 2*2^32 and n <= 4096 coords keep segment sums < 2^46.
    out[nz_rows] = _carry_norm(np.add.reduceat(term, starts, axis=0)).astype(np.uint32)
    return out


@lru_cache(maxsize=16)  # decode sizes tables by each batch's own L1 ceiling
def _decode_tables(n: int, k_max: int):
    """Decode-side companions of the NP table.

    ``dp2[r] = 2*DP[r]`` pre-doubled and carry-normalized, so the fire-block
    residual ``idx - NP[r+1, k] + dp2[r, k-m+1]`` starts with limbs already
    in (-2^32, 2*2^32) and normalizes in ~2 carry passes.  The hot-path
    comparisons run on scalar float64 proxies: ``fnp[r][t]`` is N_p(r, t)
    scaled by 2^(-32*(las[r]-2)), a per-position common factor that keeps
    proxies inside float64 range (tables under the byte cap can exceed
    2^1024); comparisons at one position all share the factor.  ``wsc[la]``
    is the matching full-L limb weight vector — limbs above ``las[r]`` are
    exactly zero for every in-range value, so no trimming is needed.
    """
    NP, DP = enum_tables(n, k_max)
    L = NP.shape[-1]
    sig = NP[1:, k_max] != 0  # row r: N_p(r+1, k_max)
    las = np.maximum(L - np.argmax(sig[:, ::-1], axis=1), 1)
    las[~sig.any(axis=1)] = 1
    # 2*DP[r, j] is only ever gathered at j <= k_max (j = k-m+1 with m >= 1),
    # where it fits L limbs; the j = k_max+1 column may wrap — it is unused.
    dp2 = _carry_norm(DP << 1)
    wsc = {
        la: np.ldexp(np.ones(L), _LIMB_BITS * (np.arange(L) - la + 2))
        for la in set(int(x) for x in las)
    }
    fnp = [NP[r] @ wsc[int(las[r])] for r in range(n)]
    # Fire-block companions, trimmed to the las[r] limbs that are live at
    # position r (every in-range value's upper limbs are exactly zero, so
    # the residual arithmetic and carry passes only touch la columns):
    # ntab[r] = N_p(r+1, .), dtab[r] = 2*DP[r, .], ztab[r] = N_p(r, .).
    ntab = [np.ascontiguousarray(NP[r + 1, :, : las[r]]) for r in range(n)]
    dtab = [np.ascontiguousarray(dp2[r, :, : las[r]]) for r in range(n)]
    ztab = [np.ascontiguousarray(NP[r, :, : las[r]]) for r in range(n)]
    wtr = {la: np.ascontiguousarray(w[:la]) for la, w in wsc.items()}
    # cumulative magnitude thresholds, same proxy scale as fnp[r]:
    # tcz[r][k, m] = 2 * sum_{j=1..m} N_p(r, k-j) (column 0 is the zero
    # floor), so the decoded magnitude of a live row is 1 + (#thresholds
    # <= u) — one broadcasted compare instead of a level-by-level scan —
    # and tcz[r][k, m-1] is the float floor of level m for the sign test
    tcz = []
    for r in range(n):
        if k_max == 0:
            tcz.append(np.zeros((1, 1)))
            continue
        pad = np.concatenate([np.zeros(k_max), fnp[r]])
        wv = np.lib.stride_tricks.sliding_window_view(pad, k_max)
        cum = 2.0 * np.cumsum(wv[: k_max + 1, ::-1], axis=1)
        tcz.append(np.ascontiguousarray(np.pad(cum, ((0, 0), (1, 0)))))
    # fused fire-block residual table, two's-complement mod 2^(32*la):
    # cfl[r][kf, kn+1, s] = 2*DP[r, kn+1] - N_p(r+1, kf) - s*N_p(r, kn),
    # so a fired row commits with one gather + one add + one carry pass
    # (the sign s comes from the float proxies; a boundary mistake lands
    # the residual outside [0, N_p(r, kn)) and is redone exactly).  The
    # table is quadratic in k, so it is built only under a memory cap —
    # None falls back to the two-gather + ztab path.
    cfl = None
    cbytes = 16 * n * (k_max + 1) * (k_max + 2) * int(las.max())
    if cbytes <= 48 * 2**20:
        jz = np.arange(k_max + 2) - 1  # kn for each column j = kn+1
        cfl = []
        for r in range(n):
            d = dtab[r][None, :, :] - ntab[r][:, None, :]
            zj = np.take(ztab[r], jz, axis=0, mode="wrap")
            both = np.stack([d, d - zj[None, :, :]], axis=2)
            la = int(las[r])
            cfl.append(_carry_norm(both).reshape(-1, la))
    return dp2, las, wsc, fnp, ntab, dtab, ztab, wtr, tcz, cfl


def _int_of_limbs(row) -> int:
    """Exact Python-int value of a little-endian int64 limb row (any sign mix)."""
    v = 0
    for x in row[::-1].tolist():
        v = (v << _LIMB_BITS) + x
    return v


def _exact_step(idx, fidx, k_rem, out, j, u, k, r, pos, scale_exp):
    """Exact bigint decode of one ladder position for one suspect row.

    The vectorized scan flags a row as suspect whenever a float-proxy
    comparison fell inside its rounding band (or its reconstructed residual
    failed the [0, N_p(r, k_new)) range check); this redoes the position
    from the row's pre-fire rank ``u`` and L1 budget ``k`` with Python ints
    and writes all of the row's state (limbs, proxy, k_rem, out) back,
    overwriting whatever the vector path committed.
    """
    val = 0
    c = num_points(r, k)
    if u >= c:
        u -= c
        m = 1
        while m <= k:
            c = num_points(r, k - m)
            if u < c:
                val = m
                break
            u -= c
            if u < c:
                val = -m
                break
            u -= c
            m += 1
        else:
            raise ValueError("rank out of range for P(n, k)")
    out[j, pos] = val
    k_rem[j] = k - abs(val)
    L = idx.shape[-1]
    limbs = np.frombuffer(u.to_bytes(4 * L, "little"), dtype=np.uint32)
    idx[j] = limbs.astype(np.int64)
    sh = max(0, u.bit_length() - 53)  # keep full float64 precision in the proxy
    fidx[j] = np.ldexp(float(u >> sh), sh + scale_exp)


def index_to_vector_batch(
    ranks: np.ndarray, k_g: np.ndarray, n: int, k_max: int
) -> np.ndarray:
    """Inverse of :func:`vector_to_index_batch`.

    ranks: (G, L) uint32 limb array; k_g: per-group L1 norms. Returns (G, n)
    int64 pulse rows.

    The hot loop is one pass per coordinate over all groups at once.  Live
    rows read their magnitude off precomputed cumulative thresholds in one
    broadcasted compare against scalar float64 proxies (no limb arithmetic,
    no per-level scan); the exact residual of a fired row
    is then reconstructed in one shot from the encode identity
    ``skip(+/-m) = N_p(r+1, k) - 2*DP[r, k-m+1] (+ N_p(r, k-m) if negative)``
    and verified against the range invariant ``0 <= res < N_p(r, k-m)``.
    Any float rounding mistake lands the residual outside that range (wrong
    magnitude, sign, or liveness are all equivalent to an out-of-band
    ``u``), so mis-scanned rows are provably flagged and redone exactly via
    :func:`_exact_step`; clean rows commit without ever comparing limbs.
    """
    ranks = np.asarray(ranks, dtype=np.uint32)
    k_g = np.asarray(k_g, dtype=np.int64)
    n, k_max = int(n), int(k_max)
    NP, _ = enum_tables(n, k_max)
    L = NP.shape[-1]
    if ranks.ndim != 2 or ranks.shape[-1] != L:
        raise ValueError(f"expected (G, {L}) rank limbs, got shape {ranks.shape}")
    g = ranks.shape[0]
    if k_g.shape != (g,):
        raise ValueError(f"k_g shape {k_g.shape} does not match {g} groups")
    if g == 0:
        return np.zeros((0, n), dtype=np.int64)
    k_batch = int(k_g.max())
    if k_batch > k_max or int(k_g.min()) < 0:
        raise ValueError(f"group L1 out of range for k_max {k_max}")
    if k_batch == 0:
        return np.zeros((g, n), dtype=np.int64)
    # heavy outlier rows shouldn't force wide limbs on everyone: when the
    # 90th-percentile L1 needs strictly fewer limbs than the batch max,
    # decode the bulk narrow and the heavy tail at full width separately
    # (the cap widens to the last k that still fits the narrow limb count)
    if g > 512:
        L_hi = limb_count(n, k_batch)
        p90 = (9 * g) // 10
        k90 = max(int(np.partition(k_g, p90)[p90]), 1)
        if limb_count(n, k90) < L_hi:
            cap = k90
            while cap + 1 < k_batch and limb_count(n, cap + 1) == limb_count(n, k90):
                cap += 1
            ni = np.flatnonzero(k_g <= cap)
            wi = np.flatnonzero(k_g > cap)
            out = np.empty((g, n), dtype=np.int64)
            out[ni] = index_to_vector_batch(ranks[ni], k_g[ni], n, k_max)
            out[wi] = index_to_vector_batch(ranks[wi], k_g[wi], n, k_max)
            return out
    # size the ladder by the batch's real L1 ceiling, not the wire-format
    # k_max: every gather below only ever touches table rows <= k_batch,
    # and valid ranks fit the (usually much narrower) k_batch limb count —
    # fewer limbs shrink the fire/carry/commit arithmetic and the fused
    # table quadratically.  Limbs above that width are zero for any
    # in-range rank; a nonzero one (corrupt stream) keeps the full width
    # so the range checks see the whole value.
    k_eff = k_batch
    L2 = limb_count(n, k_eff)
    if L2 < L and ranks[:, L2:].any():
        k_eff, L2 = k_max, L
    dp2, las, wsc, fnp, ntab, dtab, ztab, wtr, tcz, cfl = _decode_tables(n, k_eff)
    idx = ranks[:, :L2].astype(np.int64)
    k_rem = k_g.copy()
    out = np.zeros((g, n), dtype=np.int64)
    rel = np.ldexp(1.0, -45)  # proxy operands carry <= ~2^-49 relative error
    ones = np.ones(max(k_eff, 1))
    la_cur = int(las[n - 1])
    fidx = idx @ wsc[la_cur]
    for pos in range(n):
        r = n - 1 - pos
        la = int(las[r])
        if la != la_cur:  # re-scale the rank proxies to this position's factor
            fidx = fidx * np.ldexp(1.0, _LIMB_BITS * (la_cur - la))
            la_cur = la
        ft, w = fnp[r], wsc[la]
        ft0 = ft[k_rem]
        fu = fidx - ft0  # rank minus the v=0 subtree count, in proxy scale
        # rows whose v=0 test fell inside the rounding band may really fire:
        # redo them exactly (fired rows are instead vetted by the range check)
        sus = (fu < 0.0) & (fu >= (fidx + ft0) * -rel)
        # live rows (v != 0 here, ~K/n of the batch) read their magnitude
        # straight off the cumulative thresholds: m = 1 + #(t_m <= u).  A
        # proxy error near a boundary picks the wrong side exactly like the
        # level scan would — the fire-block range check flags either way
        # (m > k_row overshoots to kn < 0, also flagged).
        fi = np.flatnonzero(fu >= 0.0)
        if fi.size:
            fuc = fu[fi]
            kf = k_rem[fi]
            mm = max(int(kf.max()), 1)
            cmp = fuc[:, None] >= tcz[r][:, 1 : mm + 1][kf]
            mf = (cmp @ ones[:mm]).astype(np.int64) + 1
            kn = kf - mf
            wl = wtr[la]
            fhi = ft[kn]
            pre = idx[fi, :la]
            if cfl is not None:
                # sign from the float proxies: the in-level offset past
                # N_p(r, kn) means v = -m; then commit with a single fused
                # gather (see _decode_tables) — a mis-signed boundary row
                # wraps mod 2^(32*la) and fails the range check below
                negm = fuc - tcz[r][kf, mf - 1] >= fhi
                res = pre + cfl[r][((kf * (k_eff + 2) + kn + 1) << 1) + negm]
                res = _carry_norm(res)  # nonneg limbs; top carry-out drops
                fres = res @ wl
                bnd = (fres + fhi) * rel
            else:
                res = pre - ntab[r][kf]
                res += dtab[r][kn + 1]
                fres = res @ wl
                bnd = (np.abs(fres) + fhi) * rel
                negm = fres >= fhi  # residual past the +m band means v = -m
                ngi = np.flatnonzero(negm)
                if ngi.size:
                    res[ngi] -= ztab[r][kn[ngi]]
                res = _carry_norm(res)  # negatives wrap high, fail the check
                fres = res @ wl
            # range invariant: certainly-inside via the float band, or res
            # exactly 0 (every group's final pulse lands there; post-carry
            # limbs are nonnegative so fres == 0.0 iff all limbs are zero);
            # kn < 0 means the magnitude overshot the row's own L1 budget,
            # never a valid fire
            clean = (((fres > bnd) & (fres < fhi - bnd)) | (fres == 0.0)) & (kn >= 0)
            idx[fi, :la] = res
            fidx[fi] = fres
            k_rem[fi] = kn
            out[fi, pos] = np.where(negm, -mf, mf)
            if not clean.all():
                bi = np.flatnonzero(~clean)
                scale_exp = _LIMB_BITS * (2 - la)
                for t in bi.tolist():
                    j = int(fi[t])
                    _exact_step(
                        idx, fidx, k_rem, out, j,
                        _int_of_limbs(pre[t]), int(kf[t]), r, pos, scale_exp,
                    )
        if sus.any():
            scale_exp = _LIMB_BITS * (2 - la)
            for j in np.flatnonzero(sus).tolist():
                _exact_step(
                    idx, fidx, k_rem, out, j,
                    _int_of_limbs(idx[j]), int(k_rem[j]), r, pos, scale_exp,
                )
    return out
