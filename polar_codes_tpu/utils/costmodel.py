"""Hand-derived FLOP/byte accounting for the codec paths.

XLA's `compiled.cost_analysis()` counts before fusion, and reports no
flops at all for some programs. This module derives the counts from the
decoder's own specialized tree, so `mfu`/`bound` are defined on every row
(the reference's CodeThr/InfoThr counter discipline,
/root/reference/benchmark/main_benchmark.cpp:233-239, extended with
roofline fields).

Op-count conventions (per element, documented so the numbers are
auditable rather than precise to the last instruction):

- f (min-sum):        4  (two |x|, one min, one sign combine)
- g:                  2  (fma; +2 in int8 saturating mode is ignored)
- combine (XOR/mul):  1
- select-chain gather of a [w, S] state by a [w] perm: 2*(w_in-1) per
  output element (compare + select per chain link)
- iterative extraction (prune/weakest): rounds * 4 per candidate
  (max-reduce, compare, first-index min, mask)

Byte accounting: the ops round-trip device memory between (fusion groups
of) tree levels, so each branch's f/g operands are counted read+write at
the state dtype.
"""

from __future__ import annotations

import numpy as np

_F, _G, _XOR = 4.0, 2.0, 1.0


def _tree_widths(decoder):
    """[(node, w_in, w_out)] in execution order, via the static widening
    rule of models/scl.py (_prune keeps every candidate until w*C > L)."""
    from ..models.tree import NodeKind

    out = []

    def walk(node, w):
        if node.kind == NodeKind.BRANCH:
            w_mid = walk(node.left, w)
            w_out = walk(node.right, w_mid)
            out.append((node, w, w_out))
            return w_out
        n_list = decoder.list_size
        if node.kind == NodeKind.RATE0:
            w_out = w
        elif node.kind == NodeKind.RATE1:
            w_out = min(w * (2 if node.length == 1 else 4), n_list)
        elif node.kind == NodeKind.REP:
            w_out = min(w * 2, n_list)
        elif node.kind == NodeKind.SPC:
            w_out = min(w * 8, n_list)
        else:  # ENUM
            w_out = min(w * decoder._enum_table(node).shape[0], n_list)
        out.append((node, w, w_out))
        return w_out

    walk(decoder.tree, 1)
    return out


def _leaf_candidates(decoder, node):
    from ..models.tree import NodeKind

    if node.kind == NodeKind.RATE0:
        return 1
    if node.kind == NodeKind.RATE1:
        return 2 if node.length == 1 else 4
    if node.kind == NodeKind.REP:
        return 2
    if node.kind == NodeKind.SPC:
        return 8
    return decoder._enum_table(node).shape[0]


def scl_costs(decoder, batch: int) -> dict:
    """FLOPs/bytes per decode() call of SCLDecoder."""
    from ..models.tree import NodeKind

    n_list = decoder.list_size
    n_len = decoder.block_length
    sdt = 4.0  # f32 LLR state bytes
    flops = 0.0
    hbm = 0.0
    for node, w_in, w_out in _tree_widths(decoder):
        s = node.length
        if node.kind == NodeKind.BRANCH:
            half = s / 2
            # f + g + combine at this branch's width
            flops += w_in * half * _F + w_out * half * (_G + _XOR)
            # llr re-gather after left + left_bits re-gather after right
            fork = 2.0 * max(w_in - 1, 0)
            flops += w_out * s * fork + w_out * half * fork
            # operands round-trip memory between fusion groups: f reads
            # [w,S], writes [w,S/2]; g likewise; combine rw [w,S/2];
            # bits are int8 (1 B), LLRs state-dtype
            hbm += (w_in * (s + half) * sdt      # f
                    + w_out * (s + half) * sdt   # g (post-gather read)
                    + w_out * s * 1.0 * 2)       # combine bits rw
        else:
            n_cand = _leaf_candidates(decoder, node)
            # metric deltas (min0/weakest sums ~ 2 passes over the span)
            flops += w_in * s * 4.0
            flops += n_cand * w_in * 2.0
            if w_in * n_cand > n_list:  # iterative extraction runs
                flops += n_list * n_cand * w_in * 4.0
            # decision-bit construction ~ 2 passes over [w_out, S]
            flops += w_out * s * 2.0
            hbm += w_in * s * sdt + w_out * s * 1.0
    # CRC-aided selection: check matmul [L, K] x [K, tail] on {0,1}
    tail = getattr(decoder.detector, "tail_bits", 0)
    if tail:
        flops += 2.0 * n_list * decoder.info_length * tail
        hbm += n_list * n_len * 1.0
    # final info extraction + argmax
    flops += n_list * 4.0
    hbm += n_len * sdt + n_len * 1.0  # input LLR read + codeword write
    return {"flops": flops * batch, "bytes_accessed": hbm * batch}


def fastssc_costs(decoder, batch: int) -> dict:
    """FLOPs/bytes per decode() of FastSSCDecoder (L=1 tree)."""
    from ..models.tree import NodeKind

    n_len = decoder.block_length
    flops = 0.0
    hbm = 0.0

    def walk(node):
        nonlocal flops, hbm
        s = node.length
        if node.kind == NodeKind.BRANCH:
            half = s / 2
            flops += half * (_F + _G + _XOR)
            hbm += (s + half) * 4.0 * 2 + s * 1.0 * 2
            walk(node.left)
            walk(node.right)
        else:
            flops += s * 3.0  # hard decisions / rep / spc passes
            hbm += s * 4.0 + s * 1.0

    walk(decoder.tree)
    hbm += n_len * 4.0 + n_len * 1.0
    return {"flops": flops * batch, "bytes_accessed": hbm * batch}


def encode_costs(encoder, batch: int) -> dict:
    """FLOPs/bytes per encode() of PolarEncoder: two GF(2) matmuls plus
    mod-2 folds per Kronecker-factored transform."""
    from ..ops.butterfly import default_inner

    n_len = encoder.block_length
    passes = 2 if encoder.systematic else 1
    ni = default_inner(n_len)
    no = n_len // ni
    flops = passes * (2.0 * n_len * (ni + no) + 4.0 * n_len)
    hbm = n_len * (4.0 + 1.0) + ni * ni + no * no
    # CRC generation: GF(2) affine map as matmul over the info block
    tail = getattr(encoder.detector, "tail_bits", 0)
    if tail:
        flops += 2.0 * encoder.info_length * tail
    return {"flops": flops * batch, "bytes_accessed": hbm * batch}


def scan_costs(decoder, batch: int) -> dict:
    """FLOPs/bytes per decode() of ScanDecoder."""
    n_len = decoder.block_length
    stages = int(np.log2(n_len))
    sweeps = decoder.iterations
    # one sweep: f+g over every level down and partial sums up
    per_sweep = n_len * stages * (_F + _G + 1.0)
    flops = sweeps * per_sweep
    hbm = sweeps * stages * n_len * 4.0 * 3
    return {"flops": flops * batch, "bytes_accessed": hbm * batch}


def large_costs(decoder, batch: int) -> dict:
    """FLOPs/bytes per decode() of LargeSC/LargeSCLDecoder (scan-over-
    schedule): per-bit SC math plus the per-step carried state traffic
    that dominates it (the scan carry round-trips memory every step)."""
    n_len = decoder.block_length
    stages = int(np.log2(n_len))
    n_list = getattr(decoder, "list_size", 1)
    chunk = decoder.chunk
    steps = n_len // chunk
    flops = n_list * n_len * stages * (_F + _G + _XOR)
    if n_list > 1:
        flops += steps * n_list * 8 * 4.0  # per-chunk prune/perm algebra
    # control-flow copies of the carried [L, ~2N] stage state happen once
    # per DYNAMIC group — once per `unroll` chunks after the static
    # intra-body unrolling — plus the intrinsic refresh writes
    unroll = getattr(decoder, "unroll", 1) or 1
    dyn_groups = max(steps // unroll, 1)
    bits_bytes = 1.0 if n_list > 1 else 4.0  # SCL bits carried int8
    hbm = dyn_groups * n_list * n_len * (4.0 + bits_bytes)
    hbm += stages * n_list * n_len * (4.0 + bits_bytes) / 2.0  # refreshes
    hbm += n_list * n_len * 5.0
    return {"flops": flops * batch, "bytes_accessed": hbm * batch}
