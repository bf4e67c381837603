"""Successive-cancellation list (SCL) decoder, batched over codewords x paths.

Capability parity with SclAvxFloat
(/root/reference/src/polarcode/decoding/scl_avx_float.cpp): specialized tree
with RateZero / RateOne / Repetition / SPC leaves, LLR-based path metrics in
the "higher is better" orientation (Balatsoukas-Stimming et al.), the
Hashemi SSCL/SSCL-SPC candidate sets (RateOne: 2 weakest flips -> 4
candidates/path, scl_avx_float.cpp:353-414; Repetition: 2 constant-codeword
candidates :428; SPC: parity-adjusted 8-candidate table :498-586; RateZero:
metric += sum(min(llr,0)) :316-337), and CRC-aided best-path extraction with
maximum-likelihood fallback (extractBestPath :711-751).

Functional inversion of the reference's lazy-copy-on-write path storage
(datapool.txx lazyDuplicate): state is purely functional. Every tree node
call maps [..., L, span] LLRs -> [..., L, span] bipolar decisions plus a
path permutation `perm` [..., L] describing how list slots were re-parented
by forks inside the subtree. Parents apply `perm` as a cheap gather on the
list axis to their *live* local state only (the a/b halves and left bits) —
the functional analogue of lazy COW that touches exactly the 2N-sized live
recursion frontier instead of the full per-path LLR tree. Path pruning is
one `lax.top_k` over the L*C candidate metrics, replacing
simplePartialSortDescending.

List bookkeeping: slots start as 1 active path (metric 0) and L-1 inactive
slots at metric -1e30; inactive slots lose every top-k to any real candidate
and are masked out of CRC extraction (the analogue of the reference's
growing PathCount).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..construction import info_indices
from ..ops.butterfly import butterfly_transform
from ..ops.fg import (
    f_minsum,
    g_update,
    f_minsum_i8,
    g_update_i8,
    f_minsum_sat,
    g_update_sat,
)
from .tree import CodeNode, NodeKind, build_tree
from .detectors import Detector, Dummy

_NEG = -1.0e30  # metric of an inactive list slot
_ACTIVE_THRESHOLD = -1.0e29

# SPC flip-membership tables [parity, candidate, weak-index], from the
# reference's candidate construction (scl_avx_float.cpp:528-586).
_SPC_FLIPS_EVEN = np.array(
    [
        [0, 0, 0, 0], [1, 1, 0, 0], [1, 0, 1, 0], [1, 0, 0, 1],
        [0, 1, 1, 0], [0, 1, 0, 1], [0, 0, 1, 1], [1, 1, 1, 1],
    ],
    dtype=bool,
)
_SPC_FLIPS_ODD = np.array(
    [
        [1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1],
        [1, 1, 1, 0], [1, 1, 0, 1], [1, 0, 1, 1], [0, 1, 1, 1],
    ],
    dtype=bool,
)
# Whether candidate c's metric includes the -m0 term when parity is even
# (scl_avx_float.cpp:564-573); when parity is odd every candidate pays -m0.
_SPC_M0_EVEN = np.array([0, 1, 1, 1, 0, 0, 0, 1], dtype=np.float32)
# T_c: which of m1..m3 each candidate pays, for both parities.
_SPC_T = np.array(
    [
        [0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1],
        [1, 1, 0], [1, 0, 1], [0, 1, 1], [1, 1, 1],
    ],
    dtype=np.float32,
)


import os as _os

# f32 contractions whose operands are LLRs or path metrics keep full f32
# precision; at default precision a GPU may round them to TF32.
_HIGHEST = jax.lax.Precision.HIGHEST

_GATHER_MODE = _os.environ.get("SCL_GATHER", "select")
_TOPK_MODE = _os.environ.get("SCL_TOPK", "sort")


def _top_k(x, k):
    """Exact top-k along the last axis; SCL_TOPK selects the algorithm.

    "sort" = jax.lax.top_k (XLA sort). "rank" = sort-free selection: each
    element's descending rank is an all-pairs comparison count (ties broken
    toward the lower index, matching lax.top_k's stable order) and the k
    winners are compacted into their rank slots by one-hot contractions.
    Every op is elementwise or a small matmul, so the whole selection fuses
    instead of lowering to XLA's small-width sort. The contractions run at
    precision=HIGHEST so metrics pass through exactly (a default-precision
    f32 dot may round its operands to TF32 on a GPU)."""
    if _TOPK_MODE != "rank":
        return jax.lax.top_k(x, k)
    c = x.shape[-1]
    iota = jnp.arange(c)
    mi = x[..., :, None]  # [.., i, 1]
    mj = x[..., None, :]  # [.., 1, j]
    beats = (mj > mi) | ((mj == mi) & (iota[None, :] < iota[:, None]))
    rank = jnp.sum(beats, axis=-1)  # [.., c] int32, descending stable
    onehot = (rank[..., :, None] == jnp.arange(k)).astype(jnp.float32)
    vals = jnp.einsum(
        "...c,...ck->...k", x.astype(jnp.float32), onehot,
        preferred_element_type=jnp.float32, precision=_HIGHEST,
    )
    idx = jnp.einsum(
        "c,...ck->...k", iota.astype(jnp.float32), onehot,
        preferred_element_type=jnp.float32, precision=_HIGHEST,
    ).astype(jnp.int32)
    return vals.astype(x.dtype), idx


def _take_paths(x, perm, mode=None):
    """Gather [..., L, S] state along the list axis by perm [..., L].

    Default is a chain of L selects, which fuses into the surrounding
    elementwise ops. `mode="einsum"` forces a one-hot contraction, which
    reads the payload once instead of L times (the large-N scan decoders
    use it at wide spans); SCL_GATHER overrides globally for A/B tests.
    The contraction runs at precision=HIGHEST so LLRs pass through
    exactly."""
    if (mode or _GATHER_MODE) == "select":
        n_list = x.shape[-2]
        out = x[..., 0:1, :]
        for k in range(1, n_list):
            out = jnp.where(
                (perm == k)[..., None], x[..., k : k + 1, :], out
            )
        return out
    onehot = jax.nn.one_hot(perm, x.shape[-2], dtype=jnp.float32)
    out = jnp.einsum(
        "...lk,...ks->...ls", onehot, x.astype(jnp.float32),
        preferred_element_type=jnp.float32, precision=_HIGHEST,
    )
    return out.astype(x.dtype)


def _take_last(x, idx):
    """Gather along the LAST axis: x [..., C], idx [..., L] -> [..., L].

    A select chain for narrow C, a one-hot contraction (exact, at
    precision=HIGHEST) when C is wide (ENUM candidate lists)."""
    n_c = x.shape[-1]
    if _GATHER_MODE == "select" and n_c <= 16:
        out = jnp.broadcast_to(x[..., 0:1], idx.shape).astype(x.dtype)
        for c in range(1, n_c):
            out = jnp.where(idx == c, x[..., c : c + 1], out)
        return out
    onehot = jax.nn.one_hot(idx, n_c, dtype=jnp.float32)
    out = jnp.einsum(
        "...lc,...c->...l", onehot, x.astype(jnp.float32),
        preferred_element_type=jnp.float32, precision=_HIGHEST,
    )
    return out.astype(x.dtype)


# ---- progressive list widening ---------------------------------------------
# Until the tree has produced >= L candidate paths, every fork keeps ALL
# candidates: the permutation is the STATIC pattern i -> i // c (each of the
# w live paths forks into c children). Representing it symbolically as
# ("rep", c) lets forks on the frozen-heavy left edge of the tree compile to
# jnp.repeat (one tiled copy, no selects, no sort) and lets the whole prefix
# of the decode run at list width w < L — the root-level [.., L, N] state
# broadcast disappears and the biggest per-level buffers shrink by L/w.


def _apply_perm(x, perm):
    """Gather [..., w_in, S] along the list axis; perm is None (identity),
    ("rep", c) (static all-candidate fork), or a [..., w_out] index array."""
    if perm is None:
        return x
    if isinstance(perm, tuple):
        return jnp.repeat(x, perm[1], axis=-2)
    return _take_paths(x, perm)


def _compose_perms(p_early, p_late):
    """Composition mapping final slots to the slots before p_early."""
    if p_early is None:
        return p_late
    if p_late is None:
        return p_early
    if isinstance(p_early, tuple):
        if isinstance(p_late, tuple):
            return ("rep", p_early[1] * p_late[1])
        return p_late // p_early[1]
    if isinstance(p_late, tuple):
        return jnp.repeat(p_early, p_late[1], axis=-1)
    return _take_last(p_early, p_late)


def _sign(x):
    """Bipolar hard decision; -0.0 -> -1 (sign-bit convention, avx_float.h)."""
    return jnp.where(jnp.signbit(x), -1.0, 1.0).astype(x.dtype)


class SCLDecoder:
    """CRC-aided successive-cancellation list decoder.

    Decodes [..., N] channel LLRs into the best of `list_size` candidate
    paths; with a CRC detector attached this is CA-SCL, the reference's
    north-star configuration.
    """

    def __init__(
        self,
        block_length: int,
        frozen_bit_positions: Sequence[int],
        list_size: int = 8,
        systematic: bool = True,
        detector: Optional[Detector] = None,
        dtype=jnp.float32,
        enum_span: int = 16,
        max_enum_k: Optional[int] = None,
        layout: str = "batch_first",
    ):
        n = block_length.bit_length() - 1
        if (1 << n) != block_length:
            raise ValueError(f"block length {block_length} is not a power of 2")
        self.block_length = block_length
        self.list_size = int(list_size)
        self.frozen = np.sort(np.asarray(frozen_bit_positions, dtype=np.int64))
        self.info_pos = info_indices(block_length, self.frozen)
        self.info_length = int(self.info_pos.size)
        self.systematic = systematic
        self.detector = detector if detector is not None else Dummy()
        # int8 = SclFipChar parity: LLR/bit state in int8 (halves the gather
        # bandwidth of path forks), path metrics stay float32
        self.dtype = jnp.dtype(dtype)
        if self.dtype not in (jnp.dtype(jnp.float32), jnp.dtype(jnp.int8),
                              jnp.dtype(jnp.bfloat16)):
            raise ValueError(
                "SCLDecoder supports float32, bfloat16 or int8 LLRs"
            )
        self._int8 = self.dtype == jnp.int8
        # int8 (SclFipChar) mode stores integer-valued LLRs in float32 with
        # saturating [-127,127] arithmetic (fi_adds_epi8 value parity).
        # dtype=bfloat16 keeps the LLR/bit state in bf16 (half the memory
        # traffic of the memory-bound decode) with metric accumulation in
        # float32; numerics differ from f32 only by bf16 rounding of the
        # channel LLRs and g-sums.
        self._sdtype = jnp.float32 if self._int8 else self.dtype
        # ENUM leaves flatten small mixed-rate subtrees into one exhaustive
        # ML-enumeration node (one batched matmul; see _leaf_enum). With
        # L=1 they would be *less* greedy than SC (pruning after the leaf
        # instead of after every bit), so L=1 keeps the reference tree to
        # preserve bit-exact SC equivalence. max_enum_k=4 is the default
        # leaf size; BLER is unaffected (ENUM is exact ML over the leaf at
        # any k).
        if max_enum_k is None:
            max_enum_k = 4
        if self.list_size == 1:
            enum_span = 0
        self.enum_span = enum_span
        self.max_enum_k = max_enum_k
        # batch_last keeps per-path state as [L, span, batch] so the batch
        # axis is the minor (contiguous) one at EVERY tree node; batch_first
        # ([.., L, span]) puts the (small, deep-node) span there. Same math,
        # same results.
        if layout not in ("batch_last", "batch_first"):
            raise ValueError(f"unknown layout {layout}")
        self.layout = layout
        self.tree: CodeNode = build_tree(
            block_length, self.frozen,
            enum_span=enum_span, max_enum_k=max_enum_k,
        )
        self._enum_tables = {}
        # L=1 SCL degenerates to plain SC: the single path always keeps its
        # best candidate, which is exactly the Fast-SSC decision at every
        # leaf. Delegate to the Fast-SSC schedule (no prune/fork machinery)
        # and recover the path metric from the
        # telescoped codeword-domain form of the aggregate min-sum metric,
        # PM(x) = sum_i min((1-2x_i) llr_i, 0)  (same identity _leaf_enum
        # uses at leaf level).
        self._sc = None
        if self.list_size == 1:
            from .fastssc import FastSSCDecoder

            self._sc = FastSSCDecoder(
                block_length, self.frozen, systematic=True,
                dtype=self.dtype,
            )

    # ---- dtype-generic arithmetic ----------------------------------------

    def _fg(self):
        if self._int8:
            return f_minsum_sat, g_update_sat
        return f_minsum, g_update

    def _mag(self, llr):
        """|llr| as float32 (metric domain)."""
        if self._sdtype != jnp.float32:
            return jnp.abs(llr.astype(jnp.float32))
        return jnp.abs(llr)

    def _min0sum(self, llr):
        """sum(min(llr, 0)) as float32 over the last axis."""
        if self._sdtype != jnp.float32:
            work = llr.astype(jnp.float32)
            return jnp.sum(jnp.minimum(work, 0.0), axis=-1)
        return jnp.sum(jnp.minimum(llr, 0.0), axis=-1)

    def _max0sum(self, llr):
        if self._sdtype != jnp.float32:
            work = llr.astype(jnp.float32)
            return jnp.sum(jnp.maximum(work, 0.0), axis=-1)
        return jnp.sum(jnp.maximum(llr, 0.0), axis=-1)

    def _hard(self, llr):
        if self._int8:
            # int-valued storage: 0 decides bit 0, as in fip_char (no -0.0
            # can survive the saturating integer arithmetic)
            return jnp.where(llr < 0, -1.0, 1.0).astype(self._sdtype)
        return _sign(llr)

    def _weakest(self, mag, count):
        """`count` smallest magnitudes + indices along the last axis.

        Iterative min/argmin extraction — lax.top_k is a full sort plus
        copies, which profiling showed dominating leaf cost."""
        cur = mag
        ms, idxs = [], []
        big = jnp.asarray(jnp.inf, mag.dtype)
        iota = jax.lax.broadcasted_iota(jnp.int32, mag.shape, mag.ndim - 1)
        for j in range(count):
            ms.append(jnp.min(cur, axis=-1))
            i = jnp.argmin(cur, axis=-1)
            idxs.append(i)
            if j + 1 < count:
                cur = jnp.where(iota == i[..., None], big, cur)
        return ms, idxs

    def _flip(self, mask):
        """Bipolar flip factors from a boolean mask."""
        one = jnp.asarray(1, self._sdtype)
        return jnp.where(mask, -one, one)

    # ---- candidate pruning ------------------------------------------------

    def _prune(self, metrics, deltas):
        """Select the best min(L, w*C) of w*C candidates.

        metrics [..., w], deltas [..., w, C] -> (new metrics [..., w'],
        source perm, candidate id [..., w']).

        Progressive widening: while w*C <= L NOTHING is pruned — every
        candidate survives, the perm is the static ("rep", C) pattern and
        the candidate ids are a host-side constant, so no sort and no
        dynamic gather is emitted at all. Past L, one lax.top_k over the
        w*C (or per-path-prepruned w*L) candidate metrics replaces the
        reference's simplePartialSortDescending.

        For wide candidate lists (ENUM leaves, C up to 2^max_enum_k) a
        per-path top-L pre-prune shrinks the global top_k input from w*C to
        w*L — no survivor can rank better than L-th within its own path."""
        n_cand = deltas.shape[-1]
        width = metrics.shape[-1]
        n_list = self.list_size
        cand = metrics[..., None] + deltas
        if width * n_cand <= n_list:
            new_metrics = cand.reshape(cand.shape[:-2] + (width * n_cand,))
            cand_id = np.tile(np.arange(n_cand), width)
            return new_metrics, ("rep", n_cand), cand_id
        if n_cand > n_list and width * n_cand > 16:
            # per-path pre-prune pays off only for wide candidate lists:
            # at <=16 total candidates the single flat top_k beats two
            # top_k passes plus the id gather (measured at N=1024: the
            # double pass made L=2 SLOWER than L=4 — SPC's 8 candidates
            # tripped this branch — while at 32 flat candidates the flat
            # sort is the slower side, so the threshold sits at 16).
            # lax.top_k (sort-based) measured faster here than k rounds of
            # max/argmax extraction — the sort amortizes across w*C
            local_vals, local_idx = _top_k(cand, n_list)
            flat = local_vals.reshape(
                local_vals.shape[:-2] + (width * n_list,)
            )
            new_metrics, idx = _top_k(flat, n_list)
            src = idx // n_list
            local_pos = idx % n_list
            cand_id = _take_last(
                local_idx.reshape(local_idx.shape[:-2] + (width * n_list,)),
                src * n_list + local_pos,
            )
            return new_metrics, src, cand_id
        flat = cand.reshape(cand.shape[:-2] + (width * n_cand,))
        new_metrics, idx = _top_k(flat, n_list)
        return new_metrics, idx // n_cand, idx % n_cand

    @staticmethod
    def _perm_vec(v, perm):
        """Gather [..., w] per-path values by a _prune perm -> [..., w']."""
        if isinstance(perm, tuple):
            return jnp.repeat(v, perm[1], axis=-1)
        return _take_last(v, perm)

    # ---- leaves -----------------------------------------------------------

    def _leaf_rate0(self, llr, metrics):
        bits = jnp.ones_like(llr)
        metrics = metrics + self._min0sum(llr)
        return bits, None, metrics

    def _leaf_rate1(self, llr, metrics):
        span = llr.shape[-1]
        hard = self._hard(llr)
        mag = self._mag(llr)
        if span == 1:
            m0 = mag[..., 0]
            deltas = jnp.stack([jnp.zeros_like(m0), -m0], axis=-1)
            new_metrics, src, cand = self._prune(metrics, deltas)
            bits = _apply_perm(hard, src) * self._flip((cand == 1)[..., None])
            return bits, src, new_metrics
        (m0, m1), (idx0, idx1) = self._weakest(mag, 2)
        zero = jnp.zeros_like(m0)
        deltas = jnp.stack([zero, -m0, -m1, -m0 - m1], axis=-1)
        new_metrics, src, cand = self._prune(metrics, deltas)
        hard_g = _apply_perm(hard, src)
        i0 = self._perm_vec(idx0, src)
        i1 = self._perm_vec(idx1, src)
        pos = jnp.arange(span)
        flip0 = ((cand == 1) | (cand == 3))[..., None] & (pos == i0[..., None])
        flip1 = ((cand == 2) | (cand == 3))[..., None] & (pos == i1[..., None])
        bits = hard_g * self._flip(flip0 | flip1)
        return bits, src, new_metrics

    def _leaf_rep(self, llr, metrics):
        d_zero = self._min0sum(llr)
        d_one = -self._max0sum(llr)
        deltas = jnp.stack([d_zero, d_one], axis=-1)
        new_metrics, src, cand = self._prune(metrics, deltas)
        bits = self._flip((cand != 0)[..., None])
        bits = jnp.broadcast_to(bits, new_metrics.shape + (llr.shape[-1],))
        return bits, src, new_metrics

    def _leaf_spc(self, llr, metrics):
        span = llr.shape[-1]
        hard = self._hard(llr)
        mag = self._mag(llr)
        ms, idx_list = self._weakest(mag, 4)  # four weakest (span >= 4)
        m = jnp.stack(ms, axis=-1)  # [..., L, 4]
        idx = jnp.stack(idx_list, axis=-1)
        parity_odd = jnp.prod(hard.astype(jnp.int32), axis=-1) < 0
        t_cost = jnp.matmul(
            m[..., 1:], jnp.asarray(_SPC_T.T), precision=_HIGHEST
        )  # [..., L, 8]
        m0 = m[..., 0:1]
        delta_even = -jnp.asarray(_SPC_M0_EVEN) * m0 - t_cost
        delta_odd = -m0 - t_cost
        deltas = jnp.where(parity_odd[..., None], delta_odd, delta_even)
        new_metrics, src, cand = self._prune(metrics, deltas)
        hard_g = _apply_perm(hard, src)
        idx_g = _apply_perm(idx, src)  # [..., L, 4]
        parity_g = self._perm_vec(parity_odd.astype(jnp.int32), src)
        if isinstance(cand, np.ndarray):
            even = jnp.asarray(_SPC_FLIPS_EVEN[cand])  # [w', 4]
            odd = jnp.asarray(_SPC_FLIPS_ODD[cand])
        else:
            # select-chain table lookup: eight selects that fuse into the
            # surrounding elementwise ops instead of a dynamic table gather
            even = jnp.zeros(cand.shape + (4,), bool)
            odd = jnp.zeros(cand.shape + (4,), bool)
            for c in range(8):
                hit = (cand == c)[..., None]
                even = jnp.where(hit, jnp.asarray(_SPC_FLIPS_EVEN[c]), even)
                odd = jnp.where(hit, jnp.asarray(_SPC_FLIPS_ODD[c]), odd)
        flips = jnp.where((parity_g == 1)[..., None], odd, even)
        pos = jnp.arange(span)
        flip_mask = jnp.any(
            flips[..., :, None] & (pos == idx_g[..., :, None]), axis=-2
        )
        bits = hard_g * self._flip(flip_mask)
        return bits, src, new_metrics

    def _enum_table(self, node: CodeNode) -> np.ndarray:
        """[n_cand, span] bipolar codeword matrix of the leaf subcode."""
        key = (node.length, tuple(int(i) for i in node.frozen))
        table = self._enum_tables.get(key)
        if table is None:
            span, frozen = node.length, node.frozen
            info = np.setdiff1d(np.arange(span), frozen)
            k = info.size
            u = np.zeros((1 << k, span), dtype=np.uint8)
            patterns = (
                np.arange(1 << k)[:, None] >> np.arange(k - 1, -1, -1)
            ) & 1
            u[:, info] = patterns
            x = u.copy()  # butterfly on the host (tiny)
            s = 1
            while s < span:
                for i in range(0, span, 2 * s):
                    x[:, i : i + s] ^= x[:, i + s : i + 2 * s]
                s *= 2
            table = (1.0 - 2.0 * x).astype(np.float32)
            self._enum_tables[key] = table
        return table

    def _leaf_enum(self, node: CodeNode, llr, metrics):
        """Exhaustive ML leaf: enumerate all subcode codewords, score each
        with the aggregate min-sum metric in one batched matmul.

        The min-sum SCL path metric telescopes to the codeword-domain
        disagreement sum  PM(x) = sum_i min((1-2x_i) llr_i, 0)
        = ((1-2x)·llr - sum|llr|)/2,  so scoring every codeword is one
        [.., L, span] x [span, n_cand] contraction and the result is
        *exact* bitwise SCL over the leaf — no candidate restriction."""
        table = self._enum_table(node)  # [n_cand, span] bipolar
        work = llr.astype(jnp.float32) if self._int8 else llr
        scores = jnp.einsum(
            "...ls,cs->...lc", work, jnp.asarray(table),
            preferred_element_type=jnp.float32, precision=_HIGHEST,
        )
        sum_abs = jnp.sum(
            jnp.abs(work).astype(jnp.float32), axis=-1, keepdims=True
        )
        deltas = 0.5 * (scores - sum_abs)
        new_metrics, src, cand = self._prune(metrics, deltas)
        if isinstance(cand, np.ndarray):
            bits = jnp.asarray(table[cand], dtype=self._sdtype)  # [w', span]
            bits = jnp.broadcast_to(bits, new_metrics.shape + table.shape[1:])
        else:
            # one-hot contraction of the candidate table (exact: one-hot
            # rows times +-1 entries)
            onehot = jax.nn.one_hot(cand, table.shape[0], dtype=jnp.float32)
            bits = jnp.einsum(
                "...lc,cs->...ls", onehot, jnp.asarray(table),
                preferred_element_type=jnp.float32, precision=_HIGHEST,
            ).astype(self._sdtype)
        return bits, src, new_metrics

    # ---- tree recursion (trace-time) --------------------------------------

    def _decode_node(self, node: CodeNode, llr, metrics):
        """[..., L, span] LLRs -> (bipolar bits, perm or None, metrics)."""
        if node.kind == NodeKind.RATE0:
            return self._leaf_rate0(llr, metrics)
        if node.kind == NodeKind.RATE1:
            return self._leaf_rate1(llr, metrics)
        if node.kind == NodeKind.ENUM:
            return self._leaf_enum(node, llr, metrics)
        if node.kind == NodeKind.REP:
            return self._leaf_rep(llr, metrics)
        if node.kind == NodeKind.SPC:
            return self._leaf_spc(llr, metrics)
        f_fn, g_fn = self._fg()
        half = node.length // 2
        a, b = llr[..., :half], llr[..., half:]
        left_bits, p_left, metrics = self._decode_node(
            node.left, f_fn(a, b), metrics
        )
        if p_left is not None:
            # one gather of the whole parent span instead of two halves
            llr_g = _apply_perm(llr, p_left)
            a, b = llr_g[..., :half], llr_g[..., half:]
        right_bits, p_right, metrics = self._decode_node(
            node.right, g_fn(a, b, left_bits), metrics
        )
        if p_right is not None:
            left_bits = _apply_perm(left_bits, p_right)
        perm = _compose_perms(p_left, p_right)
        bits = jnp.concatenate([left_bits * right_bits, right_bits], axis=-1)
        return bits, perm, metrics

    # ---- batch-last ([L, span, batch]) implementation ---------------------

    def _bl_take(self, x, perm):
        """Gather [L, S, B] state along the path axis by perm [B, L].

        A chain of L selects that fuse into the surrounding elementwise
        ops (see _take_paths). At wide f32 payloads (w >= 16,
        w*S >= 8192) the gather instead runs as a batched one-hot
        dot_general ([w_out, w_in] x [w_in, S] per batch column), at
        precision=HIGHEST so f32 payloads pass through exactly."""
        n_list = x.shape[0]
        w_out = perm.shape[-1]
        if (n_list >= 16 and x.dtype == jnp.float32
                and n_list * x.shape[1] >= 8192):
            oh = (perm[:, :, None]
                  == jnp.arange(n_list)[None, None, :]).astype(x.dtype)
            out = jax.lax.dot_general(
                oh, x,
                (((2,), (0,)), ((0,), (2,))),
                precision=_HIGHEST,
            )  # [B, w_out, S]
            return out.transpose(1, 2, 0)
        perm_t = perm.T  # [L, B]
        out = jnp.broadcast_to(x[0:1], (w_out,) + x.shape[1:])
        for k in range(1, n_list):
            out = jnp.where((perm_t == k)[:, None, :], x[k : k + 1], out)
        return out

    @staticmethod
    def _bl_take_vec(v, perm_t):
        """Gather [L, B] per-path values by perm_t [L, B] along the path
        axis: out[l, b] = v[perm_t[l, b], b]. Select chain (see _bl_take)."""
        n_list = v.shape[0]
        out = jnp.broadcast_to(v[0:1], perm_t.shape)
        for k in range(1, n_list):
            out = jnp.where(perm_t == k, v[k : k + 1], out)
        return out

    def _bl_min0sum(self, llr):
        """sum(min(llr,0)) over the span -> [B, L] float32."""
        work = (llr.astype(jnp.float32) if self._sdtype != jnp.float32
                else llr)
        return jnp.sum(jnp.minimum(work, 0), axis=1).T.astype(jnp.float32)

    def _bl_max0sum(self, llr):
        work = (llr.astype(jnp.float32) if self._sdtype != jnp.float32
                else llr)
        return jnp.sum(jnp.maximum(work, 0), axis=1).T.astype(jnp.float32)

    def _bl_weakest(self, mag, count: int):
        """`count` smallest values + indices along the span of [L, S, B].

        Returns (m [B, L, count] float32, idx [count] list of [L, B])."""
        vals, idxs = [], []
        cur = mag
        big = jnp.asarray(jnp.inf, mag.dtype)
        span = mag.shape[1]
        iota = jax.lax.broadcasted_iota(jnp.int32, (1, span, 1), 1)
        for _ in range(count):
            m = jnp.min(cur, axis=1)  # [L, B]
            i = jnp.argmin(cur, axis=1)  # [L, B]
            vals.append(m.astype(jnp.float32))
            idxs.append(i)
            cur = jnp.where(iota == i[:, None, :], big, cur)
        m_blc = jnp.stack(vals, axis=-1).transpose(1, 0, 2)  # [B, L, count]
        return m_blc, idxs

    def _bl_leaf_rate0(self, llr, metrics):
        return jnp.ones_like(llr), None, metrics + self._bl_min0sum(llr)

    def _bl_leaf_rate1(self, llr, metrics):
        span = llr.shape[1]
        hard = self._hard(llr)
        mag = (jnp.abs(llr.astype(jnp.float32))
               if self._sdtype != jnp.float32 else jnp.abs(llr))
        if span == 1:
            m0 = mag[:, 0, :].T.astype(jnp.float32)  # [B, L]
            deltas = jnp.stack([jnp.zeros_like(m0), -m0], axis=-1)
            new_metrics, src, cand = self._prune(metrics, deltas)
            bits = self._bl_take(hard, src) * self._flip(
                (cand == 1).T[:, None, :]
            )
            return bits, src, new_metrics
        m, idx = self._bl_weakest(mag, 2)
        m0, m1 = m[..., 0], m[..., 1]
        zero = jnp.zeros_like(m0)
        deltas = jnp.stack([zero, -m0, -m1, -m0 - m1], axis=-1)
        new_metrics, src, cand = self._prune(metrics, deltas)
        hard_g = self._bl_take(hard, src)
        i0 = self._bl_take_vec(idx[0], src.T)  # [L, B]
        i1 = self._bl_take_vec(idx[1], src.T)
        cand_t = cand.T  # [L, B]
        iota = jax.lax.broadcasted_iota(jnp.int32, (1, span, 1), 1)
        flip0 = ((cand_t == 1) | (cand_t == 3))[:, None, :] & (
            iota == i0[:, None, :]
        )
        flip1 = ((cand_t == 2) | (cand_t == 3))[:, None, :] & (
            iota == i1[:, None, :]
        )
        bits = hard_g * self._flip(flip0 | flip1)
        return bits, src, new_metrics

    def _bl_leaf_rep(self, llr, metrics):
        d_zero = self._bl_min0sum(llr)
        d_one = -self._bl_max0sum(llr)
        deltas = jnp.stack([d_zero, d_one], axis=-1)
        new_metrics, src, cand = self._prune(metrics, deltas)
        bits = jnp.broadcast_to(
            self._flip((cand != 0).T[:, None, :]), llr.shape
        )
        return bits, src, new_metrics

    def _bl_leaf_spc(self, llr, metrics):
        span = llr.shape[1]
        hard = self._hard(llr)
        mag = (jnp.abs(llr.astype(jnp.float32))
               if self._sdtype != jnp.float32 else jnp.abs(llr))
        m, idx = self._bl_weakest(mag, 4)  # m [B, L, 4]
        neg = jnp.sum((hard < 0).astype(jnp.int32), axis=1)  # [L, B]
        parity_odd = (neg % 2 == 1).T  # [B, L]
        t_cost = jnp.matmul(
            m[..., 1:], jnp.asarray(_SPC_T.T), precision=_HIGHEST
        )  # [B, L, 8]
        m0 = m[..., 0:1]
        delta_even = -jnp.asarray(_SPC_M0_EVEN) * m0 - t_cost
        delta_odd = -m0 - t_cost
        deltas = jnp.where(parity_odd[..., None], delta_odd, delta_even)
        new_metrics, src, cand = self._prune(metrics, deltas)
        hard_g = self._bl_take(hard, src)
        parity_g = _take_last(parity_odd.astype(jnp.int32), src)  # [B, L]
        # select-chain table lookup (see _leaf_spc)
        even = jnp.zeros(cand.shape + (4,), bool)
        odd = jnp.zeros(cand.shape + (4,), bool)
        for c in range(8):
            hit = (cand == c)[..., None]
            even = jnp.where(hit, jnp.asarray(_SPC_FLIPS_EVEN[c]), even)
            odd = jnp.where(hit, jnp.asarray(_SPC_FLIPS_ODD[c]), odd)
        flips = jnp.where((parity_g == 1)[..., None], odd, even)  # [B, L, 4]
        iota = jax.lax.broadcasted_iota(jnp.int32, (1, span, 1), 1)
        flip_mask = jnp.zeros(hard_g.shape, dtype=bool)
        for j in range(4):
            ij = self._bl_take_vec(idx[j], src.T)  # [L, B]
            fj = flips[..., j].T  # [L, B]
            flip_mask = flip_mask | (
                fj[:, None, :] & (iota == ij[:, None, :])
            )
        bits = hard_g * self._flip(flip_mask)
        return bits, src, new_metrics

    def _bl_leaf_enum(self, node, llr, metrics):
        table = self._enum_table(node)  # [n_cand, span] bipolar
        work = llr.astype(jnp.float32) if self._int8 else llr
        scores = jnp.einsum(
            "lsb,cs->blc", work, jnp.asarray(table),
            preferred_element_type=jnp.float32, precision=_HIGHEST,
        )
        sum_abs = jnp.sum(
            jnp.abs(work).astype(jnp.float32), axis=1
        ).T[..., None]  # [B, L, 1]
        deltas = 0.5 * (scores - sum_abs)
        new_metrics, src, cand = self._prune(metrics, deltas)
        # bits[l, s, b] = table[cand[b, l], s]; select chain over the (small)
        # candidate table instead of a dynamic gather (see _bl_take)
        cand_t = cand.T  # [L, B]
        tab = jnp.asarray(table, dtype=self._sdtype)  # [C, S]
        bits = jnp.broadcast_to(
            tab[0][None, :, None], cand_t.shape[:1] + tab.shape[1:] + cand_t.shape[1:]
        )
        for c in range(1, tab.shape[0]):
            bits = jnp.where(
                (cand_t == c)[:, None, :], tab[c][None, :, None], bits
            )
        return bits, src, new_metrics

    def _bl_decode_node(self, node: CodeNode, llr, metrics):
        """[L, span, B] LLRs -> (bipolar bits [L, span, B], perm, metrics)."""
        if node.kind == NodeKind.RATE0:
            return self._bl_leaf_rate0(llr, metrics)
        if node.kind == NodeKind.RATE1:
            return self._bl_leaf_rate1(llr, metrics)
        if node.kind == NodeKind.ENUM:
            return self._bl_leaf_enum(node, llr, metrics)
        if node.kind == NodeKind.REP:
            return self._bl_leaf_rep(llr, metrics)
        if node.kind == NodeKind.SPC:
            return self._bl_leaf_spc(llr, metrics)
        f_fn, g_fn = self._fg()
        half = node.length // 2
        a, b = llr[:, :half], llr[:, half:]
        left_bits, p_left, metrics = self._bl_decode_node(
            node.left, f_fn(a, b), metrics
        )
        if p_left is not None:
            llr_g = self._bl_take(llr, p_left)
            a, b = llr_g[:, :half], llr_g[:, half:]
        right_bits, p_right, metrics = self._bl_decode_node(
            node.right, g_fn(a, b, left_bits), metrics
        )
        if p_right is not None:
            left_bits = self._bl_take(left_bits, p_right)
            perm = (
                p_right
                if p_left is None
                else _take_last(p_left, p_right)
            )
        else:
            perm = p_left
        bits = jnp.concatenate([left_bits * right_bits, right_bits], axis=1)
        return bits, perm, metrics

    def _decode_paths_batch_last(self, llr_flat):
        """[B, N] -> (codewords [B, L, N], metrics [B, L], active)."""
        n_batch = llr_flat.shape[0]
        llr_l = jnp.broadcast_to(
            llr_flat.T[None, :, :],
            (self.list_size, self.block_length, n_batch),
        )
        metrics = jnp.full((n_batch, self.list_size), _NEG, dtype=jnp.float32)
        metrics = metrics.at[..., 0].set(0.0)
        bits, _, metrics = self._bl_decode_node(self.tree, llr_l, metrics)
        if self._int8:
            codewords = (bits < 0).astype(jnp.uint8)
        else:
            codewords = jnp.signbit(bits).astype(jnp.uint8)
        return codewords.transpose(2, 0, 1), metrics

    # ---- public API --------------------------------------------------------

    def decode_paths(self, llr):
        """[..., N] channel LLRs -> (codewords [..., L, N] {0,1},
        metrics [..., L], active [..., L])."""
        llr = jnp.asarray(llr, dtype=self.dtype)
        if self._sc is not None:  # L=1: plain SC via the Fast-SSC schedule
            codeword = self._sc.decode_to_codeword(llr)
            work = llr.astype(jnp.float32)
            bip = 1.0 - 2.0 * codeword.astype(jnp.float32)
            metrics = 0.5 * (
                jnp.sum(bip * work, axis=-1) - jnp.sum(jnp.abs(work), axis=-1)
            )
            return (
                codeword[..., None, :].astype(jnp.uint8),
                metrics[..., None],
                jnp.ones(metrics.shape + (1,), dtype=bool),
            )
        if self._int8:
            llr = llr.astype(self._sdtype)
        lead = llr.shape[:-1]
        if self.layout == "batch_last":
            flat = llr.reshape((-1, self.block_length))
            codewords, metrics = self._decode_paths_batch_last(flat)
            codewords = codewords.reshape(
                lead + (self.list_size, self.block_length)
            )
            metrics = metrics.reshape(lead + (self.list_size,))
            return codewords, metrics, metrics > _ACTIVE_THRESHOLD
        # progressive widening: start from ONE path per codeword; the list
        # axis grows at forks (statically, via ("rep", c) perms) until it
        # reaches L — the frozen-heavy prefix of the tree runs at width 1
        # and the [.., L, N] root broadcast never exists.
        llr_l = llr[..., None, :]
        metrics = jnp.zeros(lead + (1,), dtype=jnp.float32)
        bits, _, metrics = self._decode_node(self.tree, llr_l, metrics)
        if self._int8:
            codewords = (bits < 0).astype(jnp.uint8)
        else:
            codewords = jnp.signbit(bits).astype(jnp.uint8)
        width = metrics.shape[-1]
        if width < self.list_size:
            # degenerate tiny codes that never produce L candidates: pad
            # with inactive slots to keep the [.., L, ...] API shape
            pad = self.list_size - width
            codewords = jnp.concatenate(
                [codewords,
                 jnp.zeros(lead + (pad, self.block_length), codewords.dtype)],
                axis=-2,
            )
            metrics = jnp.concatenate(
                [metrics, jnp.full(lead + (pad,), _NEG, jnp.float32)],
                axis=-1,
            )
        active = metrics > _ACTIVE_THRESHOLD
        return codewords, metrics, active

    def decode(self, llr) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        """[..., N] channel LLRs -> (info bits [..., K], codeword [..., N],
        detector-ok [...]).

        Best-path selection mirrors extractBestPath (scl_avx_float.cpp:711):
        highest-metric path whose CRC checks; if none, the ML path."""
        codewords, metrics, active = self.decode_paths(llr)
        if self.systematic:
            info_all = codewords[..., jnp.asarray(self.info_pos)]
        else:
            u = butterfly_transform(codewords)
            info_all = u[..., jnp.asarray(self.info_pos)]
        if self.detector.tail_bits:
            ok_all = self.detector.check(info_all) & active
        else:
            ok_all = active
        score_ok = jnp.where(ok_all, metrics, _NEG)
        best_ok = jnp.argmax(score_ok, axis=-1)
        best_ml = jnp.argmax(metrics, axis=-1)
        any_ok = jnp.any(ok_all, axis=-1)
        sel = jnp.where(any_ok, best_ok, best_ml)
        info = _take_paths(info_all, sel[..., None])[..., 0, :]
        codeword = _take_paths(codewords, sel[..., None])[..., 0, :]
        detector_ok = any_ok if self.detector.tail_bits else jnp.ones_like(any_ok)
        return info, codeword, detector_ok
