"""Scan-over-schedule SC / SCL decoders for very large block lengths.

The trace-time-specialized decoders (models/fastssc.py, models/scl.py)
unroll the whole code tree into the XLA program: program size grows
linearly with N and compilation becomes the bottleneck at the reference's
benchmark extremes (main_benchmark.cpp:273-503 runs encode up to N=131072
and decode to N=8192). This module provides the bounded-compile fallback
promised in SURVEY.md section 7 hard part (d): a `lax.scan` over the SC
schedule whose compiled program size is O(chunk + log N), independent of N.

Design (a batched rendering of the classic semi-parallel SC architecture):

- The code tree is cut at chunk span M. The outer loop is a `lax.scan`
  over the T = N/M leaf chunks in natural order. The scan carry holds one
  LLR buffer and one partial-sum (bipolar bit) buffer per outer tree
  stage s = 1..log2(T), of span N >> s — the live SC frontier, total O(N)
  state instead of the O(N log N) a naive formulation would keep.
- Per step t, every outer stage is updated *predicated on scalar
  functions of t* (stage s recomputes f or g only when t is a multiple of
  2^(S-s)); scalar `jnp.where` keeps the program uniform so XLA compiles
  ONE body. The same predication drives the upward partial-sum combines
  (store-left / climb-while-right).
- The chunk itself is decoded by ONE shared unrolled recursion that is
  generic over the frozen set: the chunk's frozen mask arrives as scanned
  data ([T, M], precomputed on the host), leaves are span-1 mask-driven
  decisions. All chunks share this body, so Fast-SSC-style host
  specialization is traded for bounded program size — by construction the
  chunk decoder is *plain* SC (resp. bitwise SCL), the algorithm the
  specialized trees are shortcuts of.
- The decoded u-domain chunks are stitched together and the codeword is
  recovered with the (log N)-stage butterfly afterwards; for SCL, chunk
  codeword segments accumulate in a [.., L, N] buffer and only the top
  log2(T) butterfly stages remain to apply (the inner recursion already
  combined within chunks).

SCL specifics: the list axis rides along every outer buffer; path forks
inside a chunk compose into ONE permutation (models/scl.py perm algebra)
that is applied to the outer carry once per chunk, so per-bit forks touch
only O(M)-sized recursion state — the scan-scale analogue of the
reference's lazy-copy DataPool (datapool.txx lazyDuplicate).

Pure-chunk fast path: chunks whose frozen mask is all-frozen, all-info,
repetition, or single-parity-check (roughly half of all chunks at
production shapes) dispatch via `lax.switch` to closed-form bodies — the
Fast-SSC / SSCL leaf rules at chunk span — skipping the per-bit recursion
entirely while the program stays bounded (each body is traced once).
`fast_chunks=False` (and int8 mode, to preserve saturation value parity)
keeps every chunk on the generic body.

Capability parity: FastSscAvxFloat / SclAvxFloat semantics at block
lengths the unrolled decoders cannot reach (decoding N=32768 SCL and
N=131072 SC with seconds-scale compiles). Mixed-chunk bitwise SCL is
*exact* (per-bit forks, no SSCL candidate restriction); with fast_chunks
the pure chunks use the same SSCL candidate rules as the reference's
SclAvxFloat leaves.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..construction import info_indices
from ..ops.butterfly import butterfly_transform, butterfly_transform_bipolar
from ..ops.fg import (
    f_minsum,
    g_update,
    f_minsum_sat,
    g_update_sat,
)
from .detectors import Detector, Dummy
from .tree import CodeNode, NodeKind, build_tree
from .scl import (
    SCLDecoder,
    _NEG,
    _ACTIVE_THRESHOLD,
    _apply_perm,
    _compose_perms,
    _take_paths,
    _sign,
)


def _check_pow2(value: int, name: str) -> int:
    n = value.bit_length() - 1
    if value <= 0 or (1 << n) != value:
        raise ValueError(f"{name} {value} is not a power of 2")
    return n


def _frozen_mask_chunks(block_length, frozen, chunk):
    mask = np.zeros(block_length, dtype=bool)
    mask[np.asarray(frozen, dtype=np.int64)] = True
    return mask.reshape(block_length // chunk, chunk)


# chunk classes for the pure-chunk fast path (lax.switch branch index)
_MIXED, _RATE0, _RATE1, _REP, _SPC = range(5)


def _classify_chunks(mask_chunks):
    """[T, M] frozen masks -> [T] int32 class ids. Typical constructions
    leave ~half the chunks pure at production chunk sizes (e.g. N=131072
    M=512 BB rate-1/2: 119 of 256 chunks are rate0/rate1/rep/spc), so
    dispatching them to closed-form bodies skips about half of the
    per-bit chunk recursion — the scan-scale analogue of the Fast-SSC
    leaf shortcuts (fastssc_avx_float.cpp leaf specializations)."""
    cls = np.full(len(mask_chunks), _MIXED, dtype=np.int32)
    for i, m in enumerate(mask_chunks):
        if m.all():
            cls[i] = _RATE0
        elif not m.any():
            cls[i] = _RATE1
        elif m[:-1].all() and not m[-1]:
            cls[i] = _REP
        elif m[0] and not m[1:].any() and m.size >= 4:
            # span >= 4: the SSCL SPC rule expands the four weakest bits
            cls[i] = _SPC
    return cls


class LargeSCDecoder:
    """Successive-cancellation decoder with an O(chunk + log N) program.

    Drop-in for FastSSCDecoder at block lengths where full tree unrolling
    is too large to compile; plain SC hard decisions (bit-identical to the
    Fast-SSC shortcuts on tie-free inputs, Sarkis et al.).
    """

    def __init__(
        self,
        block_length: int,
        frozen_bit_positions: Sequence[int],
        systematic: bool = True,
        detector: Optional[Detector] = None,
        dtype=jnp.float32,
        chunk: Optional[int] = None,
        fast_chunks: bool = True,
    ):
        # The chunk body is a fully unrolled ~2*chunk-op recursion, so the
        # program grows linearly with chunk; 512 is the default.
        n = _check_pow2(block_length, "block length")
        if chunk is None:
            chunk = 512
        chunk = min(chunk, block_length)
        _check_pow2(chunk, "chunk")
        self.block_length = block_length
        self.chunk = chunk
        # fast_chunks: decode pure rate0/rate1/rep/spc chunks with the
        # closed-form Fast-SSC rules (bit-identical to per-bit min-sum SC
        # on tie-free inputs, Sarkis et al.) instead of the generic
        # recursion. Disabled in int8 mode: the closed forms sum without
        # the staged fi_adds_epi8 saturation, which would break the exact
        # fip_char value parity this class guarantees.
        self.fast_chunks = bool(fast_chunks)
        self.frozen = np.sort(np.asarray(frozen_bit_positions, dtype=np.int64))
        self.info_pos = info_indices(block_length, self.frozen)
        self.info_length = int(self.info_pos.size)
        self.systematic = systematic
        self.detector = detector if detector is not None else Dummy()
        self.dtype = jnp.dtype(dtype)
        if self.dtype not in (jnp.dtype(jnp.float32), jnp.dtype(jnp.int8)):
            raise ValueError("LargeSCDecoder supports float32 or int8 LLRs")
        # int8 (FastSscFipChar parity): integer-valued LLRs stored in f32
        # with saturating [-127,127] arithmetic — value-identical to the
        # int8/int16 path (see ops/fg.py f_minsum_sat).
        self._int8 = self.dtype == jnp.int8
        self._mask_chunks = _frozen_mask_chunks(
            block_length, self.frozen, chunk
        )
        self._outer_stages = n - _check_pow2(chunk, "chunk")

    # ---- arithmetic -------------------------------------------------------

    def _fg(self):
        if self._int8:
            return f_minsum_sat, g_update_sat
        return f_minsum, g_update

    def _hard(self, llr):
        if self._int8:
            return jnp.where(llr < 0, -1.0, 1.0).astype(llr.dtype)
        return _sign(llr)

    # ---- shared chunk decoder (unrolled, mask-driven) ---------------------

    def _chunk_sc(self, llr, mask):
        """Generic SC over one chunk: llr [B, m], mask [m] traced bool.

        Returns (x bipolar [B, m], u bipolar [B, m])."""
        m = llr.shape[-1]
        if m == 1:
            hard = self._hard(llr)
            u = jnp.where(mask[0], jnp.ones_like(hard), hard)
            return u, u
        f_fn, g_fn = self._fg()
        half = m // 2
        a, b = llr[..., :half], llr[..., half:]
        x_l, u_l = self._chunk_sc(f_fn(a, b), mask[:half])
        x_r, u_r = self._chunk_sc(g_fn(a, b, x_l), mask[half:])
        x = jnp.concatenate([x_l * x_r, x_r], axis=-1)
        u = jnp.concatenate([u_l, u_r], axis=-1)
        return x, u

    # ---- pure-chunk closed forms (Fast-SSC leaf rules at chunk span) -------
    # These mirror FastSSCDecoder._decode_rate0/.../_decode_spc
    # (fastssc.py:98-129, float path) plus the u-domain output, which for
    # every pure class equals butterfly_transform_bipolar(x) — rate0/rep
    # just have cheaper closed u forms. A tie-breaking or dtype change in
    # either copy must be applied to both. int8 never reaches these
    # (fast_chunks is gated off to preserve saturation value parity).

    def _chunk_rate0(self, llr, mask):
        ones = jnp.ones_like(llr)
        return ones, ones

    def _chunk_rate1(self, llr, mask):
        x = self._hard(llr)
        return x, butterfly_transform_bipolar(x)

    def _chunk_rep(self, llr, mask):
        u_last = self._hard(jnp.sum(llr, axis=-1, keepdims=True))
        x = jnp.broadcast_to(u_last, llr.shape)
        u = jnp.concatenate(
            [jnp.ones_like(llr[..., :-1]), u_last], axis=-1
        )
        return x, u

    def _chunk_spc(self, llr, mask):
        hard = self._hard(llr)
        parity_neg = jnp.prod(hard.astype(jnp.float32), axis=-1) < 0
        weakest = jnp.argmin(jnp.abs(llr), axis=-1)
        iota = jax.lax.broadcasted_iota(jnp.int32, llr.shape, llr.ndim - 1)
        flip = jnp.where(
            (iota == weakest[..., None]) & parity_neg[..., None], -1.0, 1.0
        ).astype(llr.dtype)
        x = hard * flip
        return x, butterfly_transform_bipolar(x)

    def _chunk_switch(self, cls, llr, mask):
        """Dispatch one chunk: pure classes take the closed form, mixed
        chunks the generic mask-driven recursion."""
        return jax.lax.switch(
            cls,
            [
                self._chunk_sc,
                self._chunk_rate0,
                self._chunk_rate1,
                self._chunk_rep,
                self._chunk_spc,
            ],
            llr,
            mask,
        )

    # ---- outer scan -------------------------------------------------------

    def _scan_decode(self, llr_flat):
        """[B, N] channel LLRs -> u-hat bipolar [B, N]."""
        n_len, m_len = self.block_length, self.chunk
        n_outer = self._outer_stages
        n_chunks = n_len // m_len
        f_fn, g_fn = self._fg()
        batch = llr_flat.shape[0]

        if n_chunks == 1:
            _, u = self._chunk_sc(
                llr_flat, jnp.asarray(self._mask_chunks[0])
            )
            return u

        init_llrs = tuple(
            jnp.zeros((batch, n_len >> s), llr_flat.dtype)
            for s in range(1, n_outer + 1)
        )
        init_bits = tuple(
            jnp.zeros((batch, n_len >> s), llr_flat.dtype)
            for s in range(1, n_outer + 1)
        )

        classes = (
            _classify_chunks(self._mask_chunks)
            if self.fast_chunks and not self._int8
            else np.full(n_chunks, _MIXED, np.int32)
        )

        def step(carry, xs):
            llrs, bits = carry
            t, mask, cls = xs
            # downward: f/g refresh of the outer stages that actually
            # trigger at step t. Stage s recomputes when t is a multiple
            # of 2^(S-s) — g for a right child (odd node index), f for a
            # left child. lax.cond (NOT jnp.where) so non-trigger steps
            # skip both the arithmetic and the full-span carry rewrite:
            # a predicated-where formulation would compute f AND g at EVERY
            # stage EVERY step, ~T/log(T) times the SC-optimal work, with
            # per-step full-span carry rewrites that are pure memory
            # traffic.
            prev = llr_flat
            new_llrs = []
            for s in range(1, n_outer + 1):
                node = t >> (n_outer - s)
                need = (t & ((1 << (n_outer - s)) - 1)) == 0

                def refresh(prev=prev, s=s, node=node):
                    span = n_len >> s
                    a, b = prev[..., :span], prev[..., span:]
                    return jax.lax.cond(
                        (node & 1) == 1,
                        lambda: g_fn(a, b, bits[s - 1]),
                        lambda: f_fn(a, b),
                    )

                cur = jax.lax.cond(
                    need, refresh, lambda s=s: llrs[s - 1]
                )
                new_llrs.append(cur)
                prev = cur
            # chunk decode (shared bodies, mask + class as data)
            x_chunk, u_chunk = self._chunk_switch(cls, prev, mask)
            # upward: store-left / climb-while-right partial-sum combines.
            # The climb depth is trailing_ones(t), a scalar: branch k of a
            # lax.switch performs EXACTLY k combines and one store, so no
            # step touches spans it does not need (the old uniform loop
            # concatenated up to span N/2 every step).
            lsb = (t + 1) & -(t + 1)  # 2^trailing_ones(t), exact in f32
            k_climb = jnp.round(jnp.log2(lsb.astype(jnp.float32)))
            k_climb = jnp.minimum(k_climb.astype(jnp.int32), n_outer)

            def up_branch(k):
                def branch():
                    nb = list(bits)
                    cur = x_chunk
                    for i in range(k):
                        s = n_outer - i
                        cur = jnp.concatenate(
                            [nb[s - 1] * cur, cur], axis=-1
                        )
                    if k < n_outer:
                        nb[n_outer - k - 1] = cur
                    return tuple(nb)

                return branch

            new_bits = jax.lax.switch(
                k_climb, [up_branch(k) for k in range(n_outer + 1)]
            )
            return (tuple(new_llrs), tuple(new_bits)), u_chunk

        xs = (
            jnp.arange(n_chunks),
            jnp.asarray(self._mask_chunks),
            jnp.asarray(classes),
        )
        _, u_chunks = jax.lax.scan(step, (init_llrs, init_bits), xs)
        # [T, B, M] -> [B, N] in natural leaf order
        return jnp.moveaxis(u_chunks, 0, -2).reshape(batch, n_len)

    # ---- public API -------------------------------------------------------

    def decode_to_codeword(self, llr):
        """[..., N] channel LLRs -> [..., N] codeword bits {0,1}."""
        llr = jnp.asarray(llr)
        if self._int8:
            llr = llr.astype(jnp.float32)
        else:
            llr = llr.astype(self.dtype)
        lead = llr.shape[:-1]
        u = self._scan_decode(llr.reshape((-1, self.block_length)))
        u01 = (
            (u < 0).astype(jnp.uint8)
            if self._int8
            else jnp.signbit(u).astype(jnp.uint8)
        )
        return butterfly_transform(u01).reshape(lead + (self.block_length,))

    def decode(self, llr) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        """[..., N] LLRs -> (info [..., K], codeword [..., N], ok [...])."""
        codeword = self.decode_to_codeword(llr)
        if self.systematic:
            info = codeword[..., jnp.asarray(self.info_pos)]
        else:
            u = butterfly_transform(codeword)
            info = u[..., jnp.asarray(self.info_pos)]
        ok = (
            self.detector.check(info)
            if self.detector.tail_bits
            else jnp.ones(info.shape[:-1], dtype=bool)
        )
        return info, codeword, ok


class LargeSCLDecoder(SCLDecoder):
    """Bitwise SCL decoder with an O(chunk + log N) program.

    Inherits pruning, perm algebra, and CRC-aided extraction from
    SCLDecoder; replaces the unrolled specialized tree with the outer-scan
    + shared-chunk schedule. Mixed chunks run exact per-bit forks (2
    candidates per info bit, frozen bits pay the rate-0 penalty), i.e.
    textbook LLR-based SCL (Balatsoukas-Stimming et al.). With
    `fast_chunks` (default), pure rate0/rate1/rep/spc chunks instead take
    the SSCL leaf rules the reference itself uses
    (scl_avx_float.cpp Rate0/Rate1/Rep/SPC decoders) — one candidate
    expansion per chunk instead of one prune per bit; ~half the chunks are
    pure at production shapes. `fast_chunks=False` keeps the fully exact
    per-bit decoder.

    `subblock` (default 16, requires fast_chunks) extends the same
    dispatch INTO mixed chunks: the per-bit recursion stops at that span
    and a runtime switch on host-classified sub-block codes applies the
    SSCL leaf rules to pure sub-blocks — in the transition band only
    ~25-40% of sub-blocks are truly mixed, so the dominant per-bit
    fork+prune work drops ~3x while the scan program stays mask-generic.
    """

    def __init__(
        self,
        block_length: int,
        frozen_bit_positions: Sequence[int],
        list_size: int = 8,
        systematic: bool = True,
        detector: Optional[Detector] = None,
        dtype=jnp.float32,
        chunk: int = 256,
        fast_chunks: bool = True,
        subblock: Optional[int] = 16,
        schedule: Optional[str] = None,
        unroll: int = 16,
        carry_dtype=None,
    ):
        n = _check_pow2(block_length, "block length")
        chunk = min(chunk, block_length)
        _check_pow2(unroll, "unroll")
        self.unroll = int(unroll)
        # scan-carry LLR storage: bf16 halves the dominant stage-buffer
        # traffic (f/g still compute in f32); None keeps the working
        # dtype (f32). Decode decisions
        # can differ from f32 storage by bf16 rounding of stage LLRs, the
        # same precision class as the reference's int8 fip_char path.
        self._carry_dtype = (jnp.dtype(carry_dtype)
                             if carry_dtype is not None else None)
        # deliberately NOT calling SCLDecoder.__init__: it builds the
        # unrolled specialized tree, which is exactly what this class
        # exists to avoid at large N.
        self.block_length = block_length
        self.list_size = int(list_size)
        self.frozen = np.sort(np.asarray(frozen_bit_positions, dtype=np.int64))
        self.info_pos = info_indices(block_length, self.frozen)
        self.info_length = int(self.info_pos.size)
        self.systematic = systematic
        self.detector = detector if detector is not None else Dummy()
        self.dtype = jnp.dtype(dtype)
        if self.dtype not in (jnp.dtype(jnp.float32), jnp.dtype(jnp.int8)):
            raise ValueError("LargeSCLDecoder supports float32 or int8 LLRs")
        self._int8 = self.dtype == jnp.int8
        self._sdtype = jnp.float32
        self.enum_span = 0
        self.max_enum_k = 0
        self.layout = "batch_first"
        self.tree = None
        self._sc = None
        self._enum_tables = {}
        self.chunk = chunk
        self.fast_chunks = bool(fast_chunks)
        # schedule: "tree" unrolls the outer levels as straight-line XLA
        # (no lax.scan/cond, whose per-step branches copy the carried
        # [B, L, *] stage buffers); its program grows with N. The DEFAULT
        # is "scan" — the bounded O(unroll*chunk + log N) program — with
        # the cond-copy cost attacked by static intra-body unrolling (see
        # decode_paths).
        if schedule is None:
            schedule = "scan"
        if schedule not in ("tree", "scan"):
            raise ValueError(f"unknown schedule {schedule}")
        # The unrolled tree's RATE1/SPC leaves use candidate-limited SSCL
        # rules, i.e. it is inherently a fast_chunks-class approximation;
        # honoring fast_chunks=False would silently hand back the
        # approximate decoder. The scan schedule is the exact path.
        if schedule == "tree" and not fast_chunks:
            raise ValueError(
                "schedule='tree' uses SSCL fast-leaf rules and cannot "
                "honor fast_chunks=False; use schedule='scan' for the "
                "exact per-bit decoder"
            )
        # int8 saturation parity is only qualified on the scan path; the
        # tree path would silently fall back, so reject it up front.
        if schedule == "tree" and jnp.dtype(dtype) == jnp.dtype(jnp.int8):
            raise ValueError(
                "schedule='tree' does not support dtype=int8; use "
                "schedule='scan' (the int8-qualified path)"
            )
        self.schedule = schedule
        self._sched_tree = None
        self._mask_chunks = _frozen_mask_chunks(
            block_length, self.frozen, chunk
        )
        self._outer_stages = n - _check_pow2(chunk, "chunk")
        # sub-block class dispatch inside mixed chunks (SSCL leaf rules
        # for pure sub-blocks); same approximation class as fast_chunks,
        # so it shares its gates (and int8 saturation-parity exclusion)
        if (subblock and self.fast_chunks and not self._int8
                and subblock < chunk):
            _check_pow2(subblock, "subblock")
            self.subblock = int(subblock)
            self._sub_classes = np.stack([
                _classify_chunks(list(m.reshape(-1, self.subblock)))
                for m in self._mask_chunks
            ])  # [T, chunk // subblock] int32
        else:
            self.subblock = None
            self._sub_classes = np.zeros(
                (len(self._mask_chunks), 1), np.int32
            )

    # ---- shared chunk decoder ---------------------------------------------

    def _leaf_bit(self, llr, metrics, frozen):
        """Span-1 mask-driven leaf: llr [B, L, 1], frozen traced scalar.

        Info bit: fork into {keep hard decision, flip} with deltas
        {0, -|llr|}. Frozen bit: forced to 0 (bipolar +1) with the rate-0
        penalty min(llr, 0); the flip candidate is killed with the
        inactive-slot metric so one uniform 2-candidate prune serves both
        cases."""
        work = llr[..., 0].astype(jnp.float32)
        mag = jnp.abs(work)
        hard = self._hard(llr)
        zero = jnp.zeros_like(mag)
        d_info = jnp.stack([zero, -mag], axis=-1)
        d_frozen = jnp.stack(
            [jnp.minimum(work, 0.0), jnp.full_like(mag, _NEG)], axis=-1
        )
        deltas = jnp.where(frozen, d_frozen, d_info)
        new_metrics, src, cand = self._prune(metrics, deltas)
        bits = _apply_perm(hard, src) * self._flip((cand == 1)[..., None])
        bits = jnp.where(frozen, jnp.ones_like(bits), bits)
        return bits, src, new_metrics

    def _chunk_scl(self, llr, mask, metrics, sub_cls=None, lo=0):
        """Generic bitwise SCL over one chunk: llr [B, L, m], mask [m].

        Returns (x bipolar [B, L, m], perm, metrics) exactly like
        SCLDecoder._decode_node. With sub_cls (per-sub-block class codes,
        [m // subblock] traced int32) the recursion stops at
        self.subblock and dispatches pure sub-blocks to the SSCL leaf
        rules."""
        m = llr.shape[-1]
        if (sub_cls is not None and self.subblock is not None
                and m == self.subblock):
            return self._subblock_switch_scl(
                sub_cls[lo // self.subblock], llr, mask, metrics
            )
        if m == 1:
            return self._leaf_bit(llr, metrics, mask[0])
        f_fn, g_fn = self._fg()
        half = m // 2
        a, b = llr[..., :half], llr[..., half:]
        left_bits, p_left, metrics = self._chunk_scl(
            f_fn(a, b), mask[:half], metrics, sub_cls, lo
        )
        if p_left is not None:
            llr_g = _apply_perm(llr, p_left)
            a, b = llr_g[..., :half], llr_g[..., half:]
        right_bits, p_right, metrics = self._chunk_scl(
            g_fn(a, b, left_bits), mask[half:], metrics, sub_cls, lo + half
        )
        if p_right is not None:
            left_bits = _apply_perm(left_bits, p_right)
        perm = _compose_perms(p_left, p_right)
        bits = jnp.concatenate([left_bits * right_bits, right_bits], axis=-1)
        return bits, perm, metrics

    def _subblock_switch_scl(self, cls, llr, mask, metrics):
        """Class-dispatched sub-block inside a mixed chunk: llr
        [B, L, subblock]. Uniform concrete (bits, perm, metrics) out."""
        n_list = self.list_size

        def identity_perm(mets):
            return jnp.broadcast_to(
                jnp.arange(n_list, dtype=jnp.int32), mets.shape
            )

        def concrete(out):
            bits, perm, mets = out
            if perm is None:
                perm = identity_perm(mets)
            return bits, perm.astype(jnp.int32), mets

        def mixed(l, m, mets):
            return concrete(self._chunk_scl(l, m, mets))

        def rate0(l, m, mets):
            return concrete(self._leaf_rate0(l, mets))

        def rate1(l, m, mets):
            return concrete(self._leaf_rate1(l, mets))

        def rep(l, m, mets):
            return concrete(self._leaf_rep(l, mets))

        def spc(l, m, mets):
            return concrete(self._leaf_spc(l, mets))

        return jax.lax.switch(
            cls, [mixed, rate0, rate1, rep, spc], llr, mask, metrics
        )

    def _chunk_switch_scl(self, cls, llr, mask, metrics, sub_cls=None):
        """Dispatch one chunk: pure classes take the SSCL leaf rules
        (SCLDecoder._leaf_*), mixed chunks the exact per-bit recursion
        (with the sub-block class dispatch when enabled). Every branch
        returns a concrete [B, L] source perm so the switch output is
        uniform (the mixed branch prunes at every bit, so its perm is
        always concrete; rate0 contributes the identity)."""
        n_list = self.list_size
        if sub_cls is None:
            sub_cls = jnp.zeros(
                (self._sub_classes.shape[1],), jnp.int32
            )

        def identity_perm(m):
            return jnp.broadcast_to(
                jnp.arange(n_list, dtype=jnp.int32), m.shape
            )

        def mixed(l, m, mets, sc):
            bits, perm, mets = self._chunk_scl(
                l, m, mets, sc if self.subblock is not None else None
            )
            if perm is None:  # degenerate: chunk with no prune at all
                perm = identity_perm(mets)
            return bits, perm, mets

        def rate0(l, m, mets, sc):
            bits, _, mets = self._leaf_rate0(l, mets)
            return bits, identity_perm(mets), mets

        def wrap(leaf):
            def body(l, m, mets, sc):
                bits, perm, mets = leaf(l, mets)
                return bits, perm.astype(jnp.int32), mets
            return body

        return jax.lax.switch(
            cls,
            [mixed, rate0, wrap(self._leaf_rate1), wrap(self._leaf_rep),
             wrap(self._leaf_spc)],
            llr, mask, metrics, sub_cls,
        )

    # ---- unrolled tree schedule ------------------------------------------

    def _chunk_scl_static(self, llr, mask_np, metrics):
        """_chunk_scl with a TRACE-TIME mask (the unrolled tree schedule
        knows each chunk's frozen set statically): same ops, same prune
        order — jnp.where on Python bools constant-folds — so it stays
        bit-identical to the mask-as-data recursion. Sub-block classes
        dispatch as plain Python branches instead of lax.switch."""
        m = llr.shape[-1]
        if self.subblock is not None and m == self.subblock:
            cls = int(_classify_chunks([mask_np])[0])
            if cls != _MIXED:
                leaf = {_RATE0: self._leaf_rate0,
                        _RATE1: self._leaf_rate1,
                        _REP: self._leaf_rep,
                        _SPC: self._leaf_spc}[cls]
                return leaf(llr, metrics)
        if m == 1:
            return self._leaf_bit(llr, metrics, bool(mask_np[0]))
        f_fn, g_fn = self._fg()
        half = m // 2
        a, b = llr[..., :half], llr[..., half:]
        left_bits, p_left, metrics = self._chunk_scl_static(
            f_fn(a, b), mask_np[:half], metrics
        )
        if p_left is not None:
            llr_g = _apply_perm(llr, p_left)
            a, b = llr_g[..., :half], llr_g[..., half:]
        right_bits, p_right, metrics = self._chunk_scl_static(
            g_fn(a, b, left_bits), mask_np[half:], metrics
        )
        if p_right is not None:
            left_bits = _apply_perm(left_bits, p_right)
        perm = _compose_perms(p_left, p_right)
        bits = jnp.concatenate([left_bits * right_bits, right_bits], axis=-1)
        return bits, perm, metrics

    def _tree_chunk(self, node: CodeNode, llr, metrics):
        """Decode one mixed span-chunk subtree of the unrolled schedule
        with the static-mask recursion."""
        mask_np = np.zeros(node.length, dtype=bool)
        mask_np[node.frozen] = True
        return self._chunk_scl_static(llr, mask_np, metrics)

    def _decode_paths_tree(self, llr_flat, lead):
        """Unrolled-tree decode: specialized CodeNode tree (leaf rules at
        MAXIMAL pure spans — a rate-0 stretch of 2048 is one leaf), f/g
        glue as straight-line XLA, mixed span-chunk subtrees through
        _tree_chunk. No lax.scan/cond: nothing forces the [B, L, *] state
        through memory copies at control-flow boundaries."""
        if self._sched_tree is None:
            self._sched_tree = build_tree(self.block_length, self.frozen)
        batch = llr_flat.shape[0]
        n_list = self.list_size
        metrics = jnp.full((batch, n_list), _NEG, jnp.float32)
        metrics = metrics.at[:, 0].set(0.0)
        llr_l = jnp.broadcast_to(
            llr_flat[:, None, :], (batch, n_list, self.block_length)
        )
        f_fn, g_fn = self._fg()

        def rec(node, llr_n, mets):
            if node.kind != NodeKind.BRANCH:
                return self._decode_node(node, llr_n, mets)  # leaf rules
            if node.length <= self.chunk:
                return self._tree_chunk(node, llr_n, mets)
            half = node.length // 2
            a, b = llr_n[..., :half], llr_n[..., half:]
            left_bits, p_left, mets = rec(node.left, f_fn(a, b), mets)
            if p_left is not None:
                llr_g = _apply_perm(llr_n, p_left)
                a, b = llr_g[..., :half], llr_g[..., half:]
            right_bits, p_right, mets = rec(
                node.right, g_fn(a, b, left_bits), mets
            )
            if p_right is not None:
                left_bits = _apply_perm(left_bits, p_right)
            perm = _compose_perms(p_left, p_right)
            bits = jnp.concatenate(
                [left_bits * right_bits, right_bits], axis=-1
            )
            return bits, perm, mets

        bits, _, metrics = rec(self._sched_tree, llr_l, metrics)
        if self._int8:
            codewords = (bits < 0).astype(jnp.uint8)
        else:
            codewords = jnp.signbit(bits).astype(jnp.uint8)
        codewords = codewords.reshape(
            lead + (n_list, self.block_length)
        )
        metrics = metrics.reshape(lead + (n_list,))
        return codewords, metrics, metrics > _ACTIVE_THRESHOLD

    # ---- outer scan -------------------------------------------------------

    def _combine_chunks(self, xhat):
        """Apply the top log2(T) butterfly stages (chunk-block granularity)
        to the accumulated chunk codeword segments [..., N] bipolar."""
        n_len, m_len = self.block_length, self.chunk
        n_chunks = n_len // m_len
        lead = xhat.shape[:-1]
        x = xhat.reshape(lead + (n_chunks, m_len))
        stride = 1
        while stride < n_chunks:
            x = x.reshape(
                lead + (n_chunks // (2 * stride), 2, stride, m_len)
            )
            upper = x[..., 0, :, :] * x[..., 1, :, :]
            x = jnp.stack([upper, x[..., 1, :, :]], axis=-3)
            x = x.reshape(lead + (n_chunks, m_len))
            stride *= 2
        return x.reshape(lead + (n_len,))

    def decode_paths(self, llr):
        """[..., N] LLRs -> (codewords [..., L, N] {0,1}, metrics, active).

        schedule="tree": unrolled specialized-tree program (straight-line
        XLA). schedule="scan": the
        O(chunk + log N) outer scan."""
        llr = jnp.asarray(llr)
        llr = llr.astype(jnp.float32) if self._int8 else llr.astype(self.dtype)
        if self._int8:
            llr = jnp.clip(llr, -127.0, 127.0)
        lead = llr.shape[:-1]
        flat = llr.reshape((-1, self.block_length))
        if self.schedule == "tree" and not self._int8:
            return self._decode_paths_tree(flat, lead)
        batch = flat.shape[0]
        n_len, m_len = self.block_length, self.chunk
        n_list = self.list_size
        n_outer = self._outer_stages
        n_chunks = n_len // m_len
        f_fn, g_fn = self._fg()

        metrics0 = jnp.full((batch, n_list), _NEG, dtype=jnp.float32)
        metrics0 = metrics0.at[:, 0].set(0.0)

        if n_chunks == 1:
            llr_l = jnp.broadcast_to(
                flat[:, None, :], (batch, n_list, n_len)
            )
            bits, _, metrics = self._chunk_switch_scl(
                jnp.int32(_MIXED), llr_l,
                jnp.asarray(self._mask_chunks[0]), metrics0,
                jnp.asarray(self._sub_classes[0]),
            )
            codewords = jnp.signbit(bits).astype(jnp.uint8)
            codewords = codewords.reshape(lead + (n_list, n_len))
            metrics = metrics.reshape(lead + (n_list,))
            return codewords, metrics, metrics > _ACTIVE_THRESHOLD

        chan = jnp.broadcast_to(flat[:, None, :], (batch, n_list, n_len))
        id_perm = jnp.broadcast_to(
            jnp.arange(n_list, dtype=jnp.int32), (batch, n_list)
        )
        # Deferred path permutation: stage buffers are stored in the path
        # order current at their LAST WRITE; per-stage lag perms ([B, L]
        # int32, composed with each chunk's perm — a tiny op) map current
        # slots to stored slots, and buffers are gathered through their
        # lag only at CONSUMPTION (a stage trigger / an upward climb).
        # The eager version gathered every carried buffer every step —
        # O(N*L) per step, T times the work the lazy-copy DataPool does.
        # bits buffers carried as {0,1} int8: exact (climb combines are
        # XOR, g converts once at consumption) at 1/4 the f32 bipolar
        # carry/gather traffic of the scan's dominant cost
        cdt = self._carry_dtype or flat.dtype
        init = dict(
            llrs=tuple(
                jnp.zeros((batch, n_list, n_len >> s), cdt)
                for s in range(1, n_outer + 1)
            ),
            bits=tuple(
                jnp.zeros((batch, n_list, n_len >> s), jnp.int8)
                for s in range(1, n_outer + 1)
            ),
            lag_l=(id_perm,) * n_outer,
            lag_b=(id_perm,) * n_outer,
            metrics=metrics0,
        )

        classes = (
            _classify_chunks(self._mask_chunks)
            if self.fast_chunks and not self._int8
            else np.full(n_chunks, _MIXED, np.int32)
        )

        # Static intra-body unrolling: the scan body decodes U chunks,
        # t = U*i + j with j a PYTHON constant. For every stage with
        # period 2^(n_outer-s) < U the refresh trigger AND the f/g choice
        # depend only on j — straight-line code, no lax.cond — and every
        # step but the last has a static climb depth tz(j+1). Each
        # lax.cond/switch in the body copies its carried [B, L, span]
        # operands; the unroll leaves ONE dynamic refresh group and ONE
        # dynamic climb per U chunks.
        # big-span gathers are one-hot contractions (exact, at
        # precision=HIGHEST): at these spans they read the payload once
        # vs L times for the select chain
        def take_big(x, perm):
            return _take_paths(x, perm, mode="einsum")

        u_steps = max(1, min(self.unroll, n_chunks))
        u_log = u_steps.bit_length() - 1
        n_blocks = n_chunks // u_steps

        def one_step(carry, i, j, mask, cls, sub_cls):
            """One chunk step at t = U*i + j (j static)."""
            llrs, bits = carry["llrs"], carry["bits"]
            lag_l, lag_b = carry["lag_l"], carry["lag_b"]
            prev = chan
            new_llrs = []
            new_lag_l = []
            for s in range(1, n_outer + 1):
                period = 1 << (n_outer - s)
                span = n_len >> s

                def do_g(s=s, span=span):
                    par = (chan if s == 1 else
                           take_big(llrs[s - 2], lag_l[s - 2]))
                    par = par.astype(flat.dtype)  # f/g compute in f32
                    a, b = par[..., :span], par[..., span:]
                    b01 = take_big(bits[s - 1], lag_b[s - 1])
                    u = (1.0 - 2.0 * b01.astype(jnp.float32)).astype(
                        a.dtype
                    )
                    return g_fn(a, b, u).astype(cdt)

                def do_f(prev=prev, span=span):
                    work = prev.astype(flat.dtype)
                    a, b = work[..., :span], work[..., span:]
                    return f_fn(a, b).astype(cdt)

                if period < u_steps:
                    # trigger + f/g choice static in j
                    if j % period == 0:
                        parity = (j >> (n_outer - s)) & 1
                        cur = do_g() if parity else do_f()
                        new_lag_l.append(id_perm)
                    else:
                        cur = llrs[s - 1]
                        new_lag_l.append(lag_l[s - 1])
                elif period == u_steps:
                    if j == 0:
                        # always triggers; f/g parity = bit 0 of i
                        cur = jax.lax.cond((i & 1) == 1, do_g, do_f)
                        new_lag_l.append(id_perm)
                    else:
                        cur = llrs[s - 1]
                        new_lag_l.append(lag_l[s - 1])
                else:  # period > U: trigger possible only at j == 0
                    if j == 0:
                        rel = period // u_steps
                        rel_log = rel.bit_length() - 1
                        need = (i & (rel - 1)) == 0

                        def refresh(rel_log=rel_log):
                            node = i >> rel_log
                            return jax.lax.cond(
                                (node & 1) == 1, do_g, do_f
                            )

                        cur = jax.lax.cond(
                            need, refresh, lambda s=s: llrs[s - 1]
                        )
                        new_lag_l.append(
                            jnp.where(need, id_perm, lag_l[s - 1])
                        )
                    else:
                        cur = llrs[s - 1]
                        new_lag_l.append(lag_l[s - 1])
                new_llrs.append(cur)
                prev = cur
            # chunk decode; all within-chunk forks compose into one perm,
            # which is NOT applied to the carries — only the [B, L] lag
            # perms compose with it
            x_chunk, perm, metrics = self._chunk_switch_scl(
                cls, prev.astype(flat.dtype), mask, carry["metrics"],
                sub_cls
            )
            new_lag_l = [_compose_perms(p, perm) for p in new_lag_l]
            lag_b = [_compose_perms(p, perm) for p in lag_b]

            # climbs combine in {0,1} int8: XOR replaces the bipolar
            # product and the stored buffers stay 1/4 the f32 size
            x01 = jnp.where(x_chunk < 0, 1, 0).astype(jnp.int8)

            def up_branch(k):
                def branch():
                    nb = list(bits)
                    nlb = list(lag_b)
                    cur = x01
                    for c in range(k):
                        s = n_outer - c
                        left = take_big(nb[s - 1], nlb[s - 1])
                        cur = jnp.concatenate([left ^ cur, cur], axis=-1)
                    if k < n_outer:
                        nb[n_outer - k - 1] = cur
                        nlb[n_outer - k - 1] = id_perm
                    return tuple(nb), tuple(nlb)

                return branch

            if j < u_steps - 1:
                # climb depth tz(j+1): static
                k_static = ((j + 1) & -(j + 1)).bit_length() - 1
                new_bits, new_lag_b = up_branch(k_static)()
            else:
                # t+1 = U*(i+1): depth u_log + tz(i+1), clamped
                lsb = (i + 1) & -(i + 1)
                z = jnp.round(jnp.log2(lsb.astype(jnp.float32)))
                z = jnp.minimum(z.astype(jnp.int32), n_outer - u_log)
                new_bits, new_lag_b = jax.lax.switch(
                    z,
                    [up_branch(min(u_log + zz, n_outer))
                     for zz in range(n_outer - u_log + 1)],
                )
            out = dict(
                llrs=tuple(new_llrs),
                bits=new_bits,
                lag_l=tuple(new_lag_l),
                lag_b=new_lag_b,
                metrics=metrics,
            )
            return out, (x_chunk, perm)

        def body(carry, xs):
            i, masks, clss, subs = xs
            outs = []
            for j in range(u_steps):
                carry, out = one_step(
                    carry, i, j, masks[j], clss[j], subs[j]
                )
                outs.append(out)
            return carry, (
                jnp.stack([o[0] for o in outs]),
                jnp.stack([o[1] for o in outs]),
            )

        n_sub_codes = self._sub_classes.shape[1]
        xs = (
            jnp.arange(n_blocks),
            jnp.asarray(self._mask_chunks).reshape(
                n_blocks, u_steps, m_len
            ),
            jnp.asarray(classes).reshape(n_blocks, u_steps),
            jnp.asarray(self._sub_classes).reshape(
                n_blocks, u_steps, n_sub_codes
            ),
        )
        final, (segs_b, qs_b) = jax.lax.scan(body, init, xs)
        segs = segs_b.reshape((n_chunks,) + segs_b.shape[2:])
        qs = qs_b.reshape((n_chunks,) + qs_b.shape[2:])
        # chunk segments were emitted in the path order current at their
        # step; map final slots back to each step's slots by composing
        # the LATER chunk perms (reverse scan over tiny [B, L] perms),
        # then gather every segment once
        def back(m, q):
            m_prev = _compose_perms(q, m)
            return m_prev, m_prev

        if n_chunks > 1:
            _, ms_rev = jax.lax.scan(back, id_perm, qs[:0:-1])
            ms = jnp.concatenate(
                [ms_rev[::-1], id_perm[None]], axis=0
            )  # [T, B, L]: ms[t] maps final slots -> step-t slots
        else:
            ms = id_perm[None]
        segs_final = _take_paths(segs, ms, mode="einsum")  # [T, B, L, M]
        xhat = jnp.moveaxis(segs_final, 0, 2).reshape(
            batch, n_list, n_len
        )
        codeword_bipolar = self._combine_chunks(xhat)
        codewords = jnp.signbit(codeword_bipolar).astype(jnp.uint8)
        metrics = final["metrics"]
        codewords = codewords.reshape(lead + (n_list, n_len))
        metrics = metrics.reshape(lead + (n_list,))
        return codewords, metrics, metrics > _ACTIVE_THRESHOLD
