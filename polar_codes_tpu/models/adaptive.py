"""Adaptive two-stage decoder: Fast-SSC first, SCL rerun on CRC failure.

Capability parity with AdaptiveFloat / AdaptiveChar / AdaptiveMixed
(/root/reference/src/polarcode/decoding/adaptive_float.cpp:33-45,
adaptive_mixed.h:26-48): a cheap L=1 pass handles the vast majority of
blocks; only blocks whose CRC fails are re-decoded with the list decoder.
"Mixed" = int8 fast pass + float32 list pass (the reference's default
precision 832).

Batched form: the reference re-decodes one failing block at a time;
here the fast pass runs on the whole [batch, N] matrix, the CRC-fail mask
is pulled to the host, failing rows are compacted into the smallest
power-of-2 bucket, and one SCL call decodes them all. Buckets keep the set
of compiled SCL shapes small (each bucket size compiles once); at a fast
BLER of p the list-decoder cost scales with ~p*batch instead of batch.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from .detectors import Detector, CRC32
from .fastssc import FastSSCDecoder
from .scl import SCLDecoder


class AdaptiveDecoder:
    """Fast-SSC + CA-SCL fallback for one (N, frozen-set) code."""

    #: decode() syncs with the host to compact CRC failures; callers that
    #: need a traceable decode must use decode_fused() instead
    decode_is_host_orchestrated = True

    def __init__(
        self,
        block_length: int,
        frozen_bit_positions: Sequence[int],
        list_size: int = 8,
        systematic: bool = True,
        detector: Optional[Detector] = None,
        fast_dtype=jnp.float32,
        list_schedule: Optional[Sequence[int]] = None,
    ):
        # the adaptive scheme is meaningless without an error detector;
        # the reference attaches CRC32 by default (decoder.cpp makeDecoder)
        self.detector = detector if detector is not None else CRC32()
        if not self.detector.tail_bits:
            raise ValueError("AdaptiveDecoder requires a CRC/CMAC detector")
        self.block_length = block_length
        self.list_size = int(list_size)
        self.systematic = systematic
        self.fast = FastSSCDecoder(
            block_length,
            frozen_bit_positions,
            systematic=systematic,
            detector=self.detector,
            dtype=fast_dtype,
        )
        # escalation schedule: CRC failures of stage i re-decode at stage
        # i+1. The reference's two-stage fast->SCL(L) is the default; a
        # multi-stage schedule (e.g. (2, 8)) multiplies throughput by
        # ~1/BLER of each cheaper stage at practical operating points.
        if list_schedule is None:
            list_schedule = (list_size,) if list_size > 1 else ()
        self.list_schedule = tuple(int(l) for l in list_schedule)
        self.stages = [
            SCLDecoder(
                block_length,
                frozen_bit_positions,
                list_size=l,
                systematic=systematic,
                detector=self.detector,
            )
            for l in self.list_schedule
        ]
        self.list = self.stages[-1] if self.stages else None
        self.info_length = self.fast.info_length
        self.dtype = jnp.dtype(fast_dtype)
        self._fast_fn = jax.jit(self.fast.decode)
        self._stage_fns = [jax.jit(s.decode) for s in self.stages]
        self._list_fn = self._stage_fns[-1] if self._stage_fns else None
        # one fused gather->stage-decode->masked-scatter program per stage;
        # the jit cache keys on the BUCKET size only (every array shape is
        # padded to it), so each bucket compiles once. A version that
        # gathered/scattered at the exact failure count recompiled the
        # update ops on almost every call (the count is near-unique).
        self._rerun_fns = [self._make_rerun(s) for s in self.stages]

    @staticmethod
    def _make_rerun(stage):
        def rerun(flat, gather_idx, scatter_idx, info, codeword, ok):
            sub = jnp.asarray(flat, jnp.float32)[gather_idx]
            s_info, s_code, s_ok = stage.decode(sub)
            # dummy bucket slots carry scatter_idx == n_rows: out of range,
            # dropped (their decoded garbage never lands anywhere)
            info = info.at[scatter_idx].set(
                s_info.astype(info.dtype), mode="drop"
            )
            codeword = codeword.at[scatter_idx].set(
                s_code.astype(codeword.dtype), mode="drop"
            )
            ok = ok.at[scatter_idx].set(s_ok, mode="drop")
            return info, codeword, ok

        return jax.jit(rerun)

    def decode(self, llr) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        """[batch, N] (or [N]) LLRs -> (info [.., K], codeword [.., N], ok).

        Host-orchestrated: the CRC mask of the fast pass selects the rows
        that get the list pass (adaptive_float.cpp:33-45, batched)."""
        llr = jnp.asarray(llr)
        single = llr.ndim == 1
        if single:
            llr = llr[None, :]
        flat = llr.reshape((-1, self.block_length))
        info, codeword, ok = self._fast_fn(
            flat.astype(self.fast.dtype)
            if self.fast.dtype != jnp.int8
            else flat
        )
        n_rows = flat.shape[0]
        for rerun in self._rerun_fns:
            ok_np = np.asarray(ok)
            failed = np.nonzero(~ok_np)[0]
            if not failed.size:
                break
            bucket = 1 << (int(failed.size - 1)).bit_length()
            bucket = min(bucket, n_rows)
            gather_idx = np.zeros(bucket, dtype=np.int32)
            gather_idx[: failed.size] = failed
            scatter_idx = np.full(bucket, n_rows, dtype=np.int32)
            scatter_idx[: failed.size] = failed
            info, codeword, ok = rerun(
                flat, jnp.asarray(gather_idx), jnp.asarray(scatter_idx),
                info, codeword, ok,
            )
        out_shape = llr.shape[:-1]
        info = info.reshape(out_shape + (self.info_length,))
        codeword = codeword.reshape(out_shape + (self.block_length,))
        ok = ok.reshape(out_shape)
        if single:
            return info[0], codeword[0], ok[0]
        return info, codeword, ok

    def decode_fused(self, llr):
        """Fully-on-device variant (no host sync): runs BOTH decoders on the
        whole batch and selects per row — jit/shard_map-safe, preferable
        when the fast-pass failure rate is high or host round-trips are
        expensive (e.g. inside the mesh-sharded Monte-Carlo step)."""
        f_info, f_code, f_ok = self.fast.decode(llr)
        if self.list is None:
            return f_info, f_code, f_ok
        l_info, l_code, l_ok = self.list.decode(jnp.asarray(llr, jnp.float32))
        use_fast = f_ok
        info = jnp.where(use_fast[..., None], f_info, l_info.astype(f_info.dtype))
        code = jnp.where(use_fast[..., None], f_code, l_code.astype(f_code.dtype))
        ok = f_ok | l_ok
        return info, code, ok
