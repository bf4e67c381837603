"""No decoder leaves a float32 contraction at default precision.

On a GPU a default-precision float32 dot_general may round its operands to
TF32 (about 10 mantissa bits). Decoders feed LLRs and path metrics into
contractions (SPC leaf costs, ENUM leaf scores, one-hot path gathers, the
rank top-k), and rounded metrics change prune decisions, so every such
contraction must ask for precision=HIGHEST. The {0,1} CRC products are
exact at any precision; the decoders here run without a detector so that
only decoder contractions are inspected.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from polar_codes_tpu.construction import frozen_bits
from polar_codes_tpu.models import scl as scl_mod
from polar_codes_tpu.models.depthfirst import DepthFirstDecoder
from polar_codes_tpu.models.detectors import CRC16
from polar_codes_tpu.models.fastssc import FastSSCDecoder
from polar_codes_tpu.models.large import LargeSCDecoder, LargeSCLDecoder
from polar_codes_tpu.models.scan import FastSScanDecoder, ScanDecoder
from polar_codes_tpu.models.scl import SCLDecoder

_DEFAULT = (None, jax.lax.Precision.DEFAULT)


def _subjaxprs(params):
    for value in params.values():
        for item in value if isinstance(value, (list, tuple)) else (value,):
            if hasattr(item, "consts") and hasattr(item, "jaxpr"):
                yield item.jaxpr
            elif hasattr(item, "eqns"):
                yield item


def _dot_generals(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for sub in _subjaxprs(eqn.params):
            yield from _dot_generals(sub)


def _default_f32_dots(fn, *args):
    """dot_generals of fn's jaxpr with two float32 operands and default
    precision."""
    jaxpr = jax.make_jaxpr(fn)(*args).jaxpr
    found = []
    for eqn in _dot_generals(jaxpr):
        dtypes = {v.aval.dtype for v in eqn.invars}
        if dtypes != {jnp.dtype(jnp.float32)}:
            continue
        precision = eqn.params.get("precision")
        parts = precision if isinstance(precision, tuple) else (precision,)
        if all(p in _DEFAULT for p in parts):
            found.append(eqn)
    return found


N, K = 64, 32
FROZEN = frozen_bits(N, K, 0.0)
N_LARGE = 256
FROZEN_LARGE = frozen_bits(N_LARGE, N_LARGE // 2, 0.0)

FAMILIES = {
    "scl_f32": lambda: (SCLDecoder(N, FROZEN, list_size=4), N),
    "scl_int8": lambda: (SCLDecoder(N, FROZEN, list_size=4,
                                    dtype=jnp.int8), N),
    "scl_bf16": lambda: (SCLDecoder(N, FROZEN, list_size=8,
                                    dtype=jnp.bfloat16), N),
    "scl_batch_last": lambda: (SCLDecoder(N, FROZEN, list_size=16,
                                          layout="batch_last"), N),
    "scl_wide_enum": lambda: (SCLDecoder(N, FROZEN, list_size=4,
                                         max_enum_k=6), N),
    "fastssc_f32": lambda: (FastSSCDecoder(N, FROZEN), N),
    "fastssc_int8": lambda: (FastSSCDecoder(N, FROZEN, dtype=jnp.int8), N),
    "scan4": lambda: (ScanDecoder(N, FROZEN, iterations=4), N),
    "fastsscan4": lambda: (FastSScanDecoder(N, FROZEN, iterations=4), N),
    "scflip8": lambda: (DepthFirstDecoder(N, FROZEN, trial_limit=8), N),
    "large_sc": lambda: (LargeSCDecoder(N_LARGE, FROZEN_LARGE, chunk=32),
                         N_LARGE),
    "large_scl_scan": lambda: (LargeSCLDecoder(N_LARGE, FROZEN_LARGE,
                                               chunk=32, unroll=2),
                               N_LARGE),
    "large_scl_tree": lambda: (LargeSCLDecoder(N_LARGE, FROZEN_LARGE,
                                               chunk=32, schedule="tree"),
                               N_LARGE),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_no_default_precision_f32_dot(family):
    dec, n_len = FAMILIES[family]()
    x = jnp.zeros((3, n_len), dec.dtype if hasattr(dec, "dtype")
                  else jnp.float32)
    assert not _default_f32_dots(dec.decode, x)


def test_rank_topk_and_einsum_gathers(monkeypatch):
    """The A/B alternatives (rank top-k, one-hot gathers) keep full
    precision too."""
    monkeypatch.setattr(scl_mod, "_TOPK_MODE", "rank")
    monkeypatch.setattr(scl_mod, "_GATHER_MODE", "einsum")
    dec = SCLDecoder(N, FROZEN, list_size=8)
    assert not _default_f32_dots(dec.decode, jnp.zeros((3, N), jnp.float32))


def test_walker_sees_default_dots():
    """Control: the CRC check's {0,1} product runs at default precision
    and the walker finds it, also inside a jitted inner function."""
    det = CRC16()
    blocks = jnp.zeros((3, K), jnp.float32)
    assert _default_f32_dots(det.check, blocks)
    assert _default_f32_dots(jax.jit(det.check), blocks)
    assert not _default_f32_dots(
        lambda b: jnp.matmul(b, b.T, precision=jax.lax.Precision.HIGHEST),
        blocks,
    )
    assert np.asarray(det.check(blocks)).shape == (3,)
