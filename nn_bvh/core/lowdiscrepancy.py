"""Low-discrepancy sequences: base-2 Sobol' (0,2)-sequence + Owen scrambling.

Vectorized replacement for the reference's table-driven Sobol machinery
(`util/lowdiscrepancy.h` + 696 KB of `sobolmatrices.cpp`): instead of shipping
1024-dimension direction-number tables, we generate the first two Sobol'
dimensions from their closed-form recurrences and *pad* higher dimensions by
hash-shuffling the sample index per (pixel, dimension) — the design of pbrt's
PaddedSobolSampler (`samplers.h`), which needs exactly these two dimensions.
All ops are 32-bit integer VPU ops; the 32x2 direction table lives in registers.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from . import rng

Array = jax.Array


def _sobol_direction_numbers() -> np.ndarray:
    """(32, 2) uint32 direction numbers for Sobol' dims 0 and 1.

    dim 0: van der Corput, v_k = 1 << (31-k).
    dim 1: primitive polynomial x+1; recurrence m_k = m_{k-1} ^ (2 m_{k-1}),
    m_1 = 1; v_k = m_k << (32-k). (Standard Sobol'/Joe-Kuo construction.)
    """
    v = np.zeros((32, 2), np.uint32)
    m = 1
    for k in range(32):
        v[k, 0] = np.uint32(1 << (31 - k))
        v[k, 1] = np.uint32((m << (31 - k)) & 0xFFFFFFFF)
        m = m ^ (2 * m)
    return v


_SOBOL_V = jnp.asarray(_sobol_direction_numbers())


def sobol_2d_bits(index: Array) -> tuple[Array, Array]:
    """Sobol' sample `index` for dims (0, 1) as uint32 bit patterns.

    Branch-free matrix-vector product over GF(2): XOR direction numbers where
    the corresponding index bit is set.
    """
    index = jnp.asarray(index, jnp.uint32)
    x = jnp.zeros_like(index)
    y = jnp.zeros_like(index)
    for k in range(32):
        bit = (index >> k) & jnp.uint32(1)
        mask = jnp.where(bit == 1, jnp.uint32(0xFFFFFFFF), jnp.uint32(0))
        x = x ^ (_SOBOL_V[k, 0] & mask)
        y = y ^ (_SOBOL_V[k, 1] & mask)
    return x, y


def reverse_bits32(v: Array) -> Array:
    v = jnp.asarray(v, jnp.uint32)
    v = ((v >> 1) & jnp.uint32(0x55555555)) | ((v & jnp.uint32(0x55555555)) << 1)
    v = ((v >> 2) & jnp.uint32(0x33333333)) | ((v & jnp.uint32(0x33333333)) << 2)
    v = ((v >> 4) & jnp.uint32(0x0F0F0F0F)) | ((v & jnp.uint32(0x0F0F0F0F)) << 4)
    v = ((v >> 8) & jnp.uint32(0x00FF00FF)) | ((v & jnp.uint32(0x00FF00FF)) << 8)
    return (v >> 16) | (v << 16)


def fast_owen_scramble(v: Array, seed: Array) -> Array:
    """Laine–Karras style hash-based Owen scramble (reference
    `util/lowdiscrepancy.h` FastOwenScrambler). Input/output are
    *bit-reversed-domain* uint32s; caller reverses around the call."""
    v = jnp.asarray(v, jnp.uint32)
    seed = jnp.asarray(seed, jnp.uint32)
    v ^= v * jnp.uint32(0x3D20ADEA)
    v += seed
    v *= (seed >> 16) | jnp.uint32(1)
    v ^= v * jnp.uint32(0x05526C56)
    v ^= v * jnp.uint32(0x53A22864)
    return v


def owen_scrambled_sobol_2d(index: Array, seed_x: Array, seed_y: Array) -> tuple[Array, Array]:
    """Owen-scrambled Sobol' dims (0,1) -> two float32 arrays in [0,1)."""
    xb, yb = sobol_2d_bits(index)
    xb = reverse_bits32(fast_owen_scramble(reverse_bits32(xb), seed_x))
    yb = reverse_bits32(fast_owen_scramble(reverse_bits32(yb), seed_y))
    return rng.uint32_to_float01(xb), rng.uint32_to_float01(yb)


def owen_shuffle_index(index: Array, n_pow2_log: int, seed: Array) -> Array:
    """Owen-shuffle a sample index within a 2^n block (index padding: decorrelates
    dimension pairs, PaddedSobolSampler semantics)."""
    index = jnp.asarray(index, jnp.uint32)
    shifted = index << (32 - n_pow2_log)
    shuffled = fast_owen_scramble(shifted, jnp.asarray(seed, jnp.uint32))
    return shuffled >> (32 - n_pow2_log)


# ---------------------------------------------------------------------------
# ZSobol sample-index scrambling (reference samplers.h ZSobolSampler,
# Ahmed & Wonka 2020 blue-noise morton ordering)
# ---------------------------------------------------------------------------

def encode_morton2(x: Array, y: Array) -> Array:
    """Interleave the low 16 bits of x and y (util/math.h EncodeMorton2)."""
    def part(v):
        v = jnp.asarray(v, jnp.uint32) & jnp.uint32(0xFFFF)
        v = (v ^ (v << 8)) & jnp.uint32(0x00FF00FF)
        v = (v ^ (v << 4)) & jnp.uint32(0x0F0F0F0F)
        v = (v ^ (v << 2)) & jnp.uint32(0x33333333)
        v = (v ^ (v << 1)) & jnp.uint32(0x55555555)
        return v

    return (part(y) << 1) | part(x)


# the 24 permutations of 4 elements, packed 2 bits per slot (perm[i] in slot i)
def _pack_perms4() -> np.ndarray:
    from itertools import permutations

    out = []
    for p in permutations(range(4)):
        v = 0
        for i, pi in enumerate(p):
            v |= pi << (2 * i)
        out.append(v)
    return np.asarray(out, np.uint32)


_PERMS4 = jnp.asarray(_pack_perms4())


def zsobol_shuffled_index(pixel_x: Array, pixel_y: Array, sample: Array,
                          log2_spp: int, dim: Array, seed) -> Array:
    """ZSobolSampler::GetSampleIndex: morton-interleave the pixel coords,
    append the sample bits, then permute the base-4 digits top-down with a
    per-(prefix, dim) hashed permutation — nearby pixels get decorrelated but
    blue-noise-distributed Sobol' index sequences.

    Note: pbrt uses a 64-bit morton index; we keep everything in uint32
    (pixel coords up to 2^13, spp up to 64 stay exact), which covers the
    practical render sizes of the reference scenes."""
    log2_spp = int(log2_spp)
    n_base4 = (2 * 13 + log2_spp + 1) // 2
    morton = (encode_morton2(pixel_x, pixel_y) << log2_spp) | jnp.asarray(
        sample, jnp.uint32)
    dim = jnp.asarray(dim, jnp.uint32)
    seed = jnp.asarray(seed, jnp.uint32)
    out = jnp.zeros_like(morton)
    for i in range(n_base4):
        shift = 2 * (n_base4 - 1 - i)
        digit = (morton >> shift) & jnp.uint32(3)
        prefix = morton >> (shift + 2)
        p = rng.hash_combine(prefix, dim, seed) % jnp.uint32(24)
        perm = _PERMS4[p]
        newd = (perm >> (2 * digit)) & jnp.uint32(3)
        out = (out << 2) | newd
    return out


# ---------------------------------------------------------------------------
# Halton radical inverse (first primes, no permutation tables: hash-perm digits)
# ---------------------------------------------------------------------------

_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def radical_inverse(base_index: int, a: Array) -> Array:
    """Radical inverse of integer a in the (base_index)-th prime base
    (reference util/lowdiscrepancy.h RadicalInverse)."""
    base = _PRIMES[base_index]
    inv_base = 1.0 / base
    # the reversed-digit accumulator must stay < 2^32: use
    # n_digits = floor(32/log2(base)) digits and fold the input into range
    # (base^n_digits), otherwise rev overflows uint32 (biased samples)
    n_digits = int(np.floor(32 / np.log2(base)))
    modulus = np.uint32(base**n_digits) if base**n_digits < 2**32 else np.uint32(0)
    a = jnp.asarray(a, jnp.uint32)
    if int(modulus) != 0:
        a = a % modulus

    def body(_, carry):
        a, rev, inv = carry
        digit = a % base
        return a // base, rev * base + digit, inv * inv_base

    a_out, rev, inv = jax.lax.fori_loop(
        0, n_digits, body, (a, jnp.zeros_like(a), jnp.ones_like(a, jnp.float32) * 1.0)
    )
    return jnp.minimum(rev.astype(jnp.float32) * inv, 1.0 - 2**-24)


# ---------------------------------------------------------------------------
# Full Sobol' matrices, GENERATED (not vendored): primitive polynomials over
# GF(2) are found programmatically and direction numbers derived by the
# standard Sobol/Bratley-Fox recurrence (the construction behind the
# reference's shipped util/sobolmatrices.cpp tables; initial values are a
# deterministic odd-value search rather than the Joe-Kuo optimized set, so
# per-dimension net properties are identical while cross-dimension
# discrepancy is slightly weaker — acceptable with Owen scrambling on top).
# ---------------------------------------------------------------------------

def _is_primitive_poly(poly: int, degree: int) -> bool:
    """poly: bit i = coefficient of x^i (bit `degree` set, bit 0 set).
    Primitive iff x has multiplicative order 2^degree - 1 in
    GF(2)[x]/(poly)."""
    n = (1 << degree) - 1
    if degree == 1:
        return poly == 0b11  # x + 1
    mask = (1 << degree) - 1

    def fmul(u, v):
        acc = 0
        while v:
            if v & 1:
                acc ^= u
            v >>= 1
            u <<= 1
            if u >> degree & 1:
                u ^= poly
            u &= mask | (1 << degree)
            u &= mask
        return acc

    def powx(e):
        r, base = 1, 2
        while e:
            if e & 1:
                r = fmul(r, base)
            base = fmul(base, base)
            e >>= 1
        return r

    if powx(n) != 1:
        return False
    f, p, facs = n, 2, set()
    while p * p <= f:
        while f % p == 0:
            facs.add(p)
            f //= p
        p += 1
    if f > 1:
        facs.add(f)
    return all(powx(n // q) != 1 for q in facs)


def _primitive_polys(count: int) -> list[tuple[int, int]]:
    """First `count` primitive polynomials as (degree, coeff-bits sans the
    leading and trailing 1), in degree order — the Sobol' convention."""
    out = []
    degree = 1
    while len(out) < count:
        for poly in range(1 << degree, 1 << (degree + 1)):
            if not (poly & 1):
                continue  # constant term must be 1
            if _is_primitive_poly(poly, degree):
                # interior coefficients a_1..a_{degree-1}
                a = (poly >> 1) & ((1 << (degree - 1)) - 1)
                out.append((degree, a))
                if len(out) >= count:
                    break
        degree += 1
    return out


def generate_sobol_matrices(n_dims: int = 64, n_bits: int = 32) -> np.ndarray:
    """(n_dims, n_bits) u32 direction-number matrices (MSB-aligned like the
    reference's SobolMatrices32)."""
    V = np.zeros((n_dims, n_bits), np.uint32)
    # dim 0: van der Corput
    for i in range(n_bits):
        V[0, i] = np.uint32(1 << (31 - i))
    polys = _primitive_polys(n_dims - 1)
    rs = np.random.RandomState(0x5350)
    for d in range(1, n_dims):
        s, a = polys[d - 1]
        # initial direction numbers m_1..m_s: odd, m_i < 2^i (deterministic
        # search; Joe-Kuo optimize these, we draw them reproducibly)
        m = [1]
        for i in range(1, s):
            m.append(int(rs.randint(0, 1 << i)) * 2 + 1)
        m = list(m)
        for i in range(s, n_bits):
            v = m[i - s] ^ (m[i - s] << s)
            for k in range(1, s):
                if (a >> (s - 1 - k)) & 1:
                    v ^= m[i - k] << k
            m.append(v & 0xFFFFFFFF)
        for i in range(n_bits):
            V[d, i] = np.uint32((m[i] << (31 - i)) & 0xFFFFFFFF)
    return V


def sobol_sample_dim(V_dim: Array, index: Array) -> Array:
    """u32 Sobol' value of `index` for one dimension's (32,) matrix."""
    idx = jnp.asarray(index, jnp.uint32)
    out = jnp.zeros_like(idx)
    for b in range(32):
        out = out ^ jnp.where((idx >> b) & 1 > 0, V_dim[b], 0)
    return out


# ---------------------------------------------------------------------------
# pmj02 point sets, GENERATED (Christensen, Kensler, Kilpatrick,
# "Progressive Multi-Jittered Sample Sequences", EGSR 2018) — replaces the
# reference's shipped pmj02tables.h with an in-repo generator.
# ---------------------------------------------------------------------------

def generate_pmj02(n: int, seed: int = 0) -> np.ndarray:
    """(n, 2) progressive (0,2) points: every prefix of size 2^k is
    stratified in ALL base-2 elementary intervals of that size — the defining
    property of pmj02 sets (Christensen et al., EGSR 2018).

    Construction: Owen-scrambled Sobol (0,2) sequence with per-point uniform
    jitter inside the 2^-32 cell — O(n), deterministic, never deadlocks.
    Nested uniform (Owen) scrambling preserves the (0,2) property of every
    prefix, so these sets satisfy the same elementary-interval guarantees as
    rejection-built pmj02 (the blue-noise *optimized* realization of the
    paper — minimum-distance selection among candidates — is not performed;
    the reference ships such realizations as data, pmj02tables.h). The prior
    rejection-sampling builder deadlocked for n >= ~1k (the free-cell
    intersection shrinks to measure ~0), ADVICE r3."""
    idx = np.arange(n, dtype=np.uint64)
    # dim 0: van der Corput (bit-reversed index); dim 1: Sobol dim-1
    # (Pascal-triangle direction numbers v_k = v_{k-1} ^ (v_{k-1} >> 1))
    x = np.zeros(n, np.uint32)
    v = idx.astype(np.uint32)
    for b in range(32):
        x = (x << np.uint32(1)) | ((v >> np.uint32(b)) & np.uint32(1))
    cols = []
    vk = 1 << 31
    for k in range(32):
        cols.append(vk)
        vk = vk ^ (vk >> 1)
    cols = np.array(cols, dtype=np.uint32)
    y = np.zeros(n, np.uint32)
    for b in range(32):
        y ^= ((idx >> np.uint64(b)) & np.uint64(1)).astype(np.uint32) * cols[b]

    def owen(u, s):
        # hash-based nested-uniform scramble (Laine-Karras rounds) applied
        # in bit-reversed space, as in util/lowdiscrepancy.h FastOwenScrambler
        r = np.zeros_like(u)
        for b in range(32):
            r = (r << np.uint32(1)) | ((u >> np.uint32(b)) & np.uint32(1))
        r = (r + np.uint32(s & 0xFFFFFFFF)) * np.uint32(0x9E3779B9)
        r ^= r * np.uint32(0x6C50B47C)
        r ^= r * np.uint32(0xB82F1E52)
        r ^= r * np.uint32(0xC7AFE638)
        r ^= r * np.uint32(0x8D22F6E6)
        u = np.zeros_like(r)
        for b in range(32):
            u = (u << np.uint32(1)) | ((r >> np.uint32(b)) & np.uint32(1))
        return u
    rs = np.random.RandomState(seed)
    sx, sy = rs.randint(0, 1 << 31, 2, dtype=np.int64)
    x = owen(x, int(sx) * 2 + 1)
    y = owen(y, int(sy) * 2 + 1)
    # keep the top 24 scrambled bits: k*2^-24 is exactly representable in
    # f32 for [0,1), so strata membership survives the float conversion
    # (jittering at 2^-32 then rounding to f32 can cross a stratum boundary)
    pts = (np.stack([x, y], 1) >> np.uint32(8)).astype(np.float64)
    return (pts * (2.0 ** -24)).astype(np.float32)


def _generate_pmj02_rejection(n: int, seed: int = 0) -> np.ndarray:
    """Historic rejection-sampling pmj02 builder (kept for reference/tests of
    the placement rule; deadlocks for large n — use generate_pmj02)."""
    rs = np.random.RandomState(seed)
    pts = np.zeros((n, 2), np.float64)
    pts[0] = rs.rand(2)
    count = 1
    # per-elementary-grid occupancy sets: occ[(a,b)] = set of occupied cells
    # in the 2^a x 2^b grid -> O(lg) membership per candidate instead of an
    # O(count * lg) scan over all placed points (ADVICE r3)
    occ: dict = {}

    def grid_of(a, b):
        key = (a, b)
        s = occ.get(key)
        if s is None:
            gx, gy = 1 << a, 1 << b
            s = {(int(pts[i, 0] * gx), int(pts[i, 1] * gy))
                 for i in range(count)}
            occ[key] = s
        return s

    def try_place(count):
        m = count + 1
        lg = 0
        while (1 << lg) < m:
            lg += 1
        grids = [(a, lg - a, grid_of(a, lg - a)) for a in range(lg + 1)]
        for _try in range(2000):
            cand = rs.rand(2)
            ok = True
            for a, b, s in grids:
                if (int(cand[0] * (1 << a)), int(cand[1] * (1 << b))) in s:
                    ok = False
                    break
            if ok:
                return cand
        return None

    def add_point(cand):
        for (a, b), s in occ.items():
            s.add((int(cand[0] * (1 << a)), int(cand[1] * (1 << b))))

    while count < n:
        checkpoint = count
        target = min(max(4 * checkpoint, 4), n)
        saved = pts[:checkpoint].copy()
        for _restart in range(100):
            failed = False
            count = checkpoint
            pts[:checkpoint] = saved
            occ.clear()
            while count < target:
                cand = try_place(count)
                if cand is None:
                    failed = True
                    break
                pts[count] = cand
                add_point(cand)
                count += 1
            if not failed:
                break
        else:
            raise RuntimeError("pmj02 generation failed to converge")
        occ.clear()  # grids for smaller prefixes are superseded
    return pts.astype(np.float32)
