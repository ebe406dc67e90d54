"""K9, K3's stage variants (``tools/probe_pfbdft_stages.py``): each
variant's plain version in ``radioframe_torch/kernels/pfb_dft.py`` against
the probe's Pallas kernel ``_kern`` in interpret mode, at M=64, K=8 and two
tiles of four frames (so the history carried across tiles is read).

The probe writes the DFT variants in native (k1, k2) order; they are
reordered to channel order, the port's only order. Tolerances: the probe's
own 2e-3 of the output scale for the variants with its bf16x3 matrix
products (``dft_only``, ``base_b3``, ``batched_b3``), 1e-5 of scale for the
polyphase-only variants, which it computes in float32."""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from radioframe_torch.kernels.pfb_dft import (BATCHED_M, VARIANTS, FusedPfbDft, ct_factors,
                                              plain_batched_tf32, plain_pfb_dft, plain_variant,
                                              tf32_round)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
M, K, F, TF = 64, 8, 8, 4
B3_TOL = 2e-3    # tools/probe_pfbdft_stages.py check_parity's bound
PFB_TOL = 1e-5
CT_TOL = 2e-4    # batched_b3 on the card against its plain version, of scale (chip_smoke.py)


@pytest.fixture(scope="module")
def probe():
    """tools/probe_pfbdft_stages.py, imported with JAX's compilation-cache
    settings restored (the probe points the cache at a directory of its own)."""
    names = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
             "jax_persistent_cache_min_entry_size_bytes")
    saved = {n: getattr(jax.config, n) for n in names}
    spec = importlib.util.spec_from_file_location(
        "probe_pfbdft_stages", ROOT / "tools" / "probe_pfbdft_stages.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for n, v in saved.items():
            jax.config.update(n, v)
    return mod


def _probe_call(probe, variant, tail, xr, xi, h):
    """The probe's pallas_call of ``_kern(variant)`` in interpret mode on
    F/TF tiles; returns (yr, yi) (F, M) as the probe orders them."""
    M1, M2, w1r, w1i, w2r, w2i, twr, twi = probe._dft_consts(M)
    bw1r = np.broadcast_to(w1r.T, (TF, M1, M1)).copy()
    bw1i = np.broadcast_to(w1i.T, (TF, M1, M1)).copy()
    twtr, twti = np.ascontiguousarray(twr.T)[None], np.ascontiguousarray(twi.T)[None]
    whole = lambda shp: pl.BlockSpec(shp, lambda i: (0,) * len(shp))  # noqa: E731
    tile = pl.BlockSpec((TF, M1, M2), lambda i: (i, 0, 0))
    yr, yi = pl.pallas_call(
        functools.partial(probe._kern, variant, TF, M1, M2),
        grid=(F // TF,),
        in_specs=[tile, tile, whole((2, K - 1, M1, M2)), whole((K, M1, M2)),
                  whole((M1, M1)), whole((M1, M1)), whole((M2, M2)), whole((M2, M2)),
                  whole((M2, M1)), whole((M2, M1)), whole((TF, M1, M1)), whole((TF, M1, M1)),
                  whole((1, M1, M2)), whole((1, M1, M2))],
        out_specs=[tile, tile],
        out_shape=[jax.ShapeDtypeStruct((F, M1, M2), jnp.float32)] * 2,
        scratch_shapes=[pltpu.VMEM((K - 1, M1, M2), jnp.float32)] * 2,
        interpret=True,
    )(*(jnp.asarray(a) for a in (xr.reshape(F, M1, M2), xi.reshape(F, M1, M2), tail,
                                 h.reshape(K, M1, M2), w1r, w1i, w2r, w2i, twr, twi,
                                 bw1r, bw1i, twtr, twti)))
    return np.asarray(yr), np.asarray(yi)


def _channel_order(y):
    """The probe's native (F, M1, M2) [k1, k2] -> (F, M), channel M1*k2 + k1."""
    return y.transpose(0, 2, 1).reshape(F, M)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(9)
    xr, xi = rng.standard_normal((2, F * M)).astype(np.float32)
    tail = rng.standard_normal((2, K - 1, M)).astype(np.float32)
    return xr, xi, tail


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_plain_matches_probe(probe, inputs, variant):
    xr, xi, tail = inputs
    k = FusedPfbDft(M, K)
    M1, M2 = ct_factors(M)
    assert (M1, M2) == probe._dft_consts(M)[:2]
    want = _probe_call(probe, variant, tail.reshape(2, K - 1, M1, M2), xr, xi, k.h.numpy())
    if variant.startswith("pfb_"):  # sample order
        want = tuple(w.reshape(F, M) for w in want)
    else:
        want = tuple(_channel_order(w) for w in want)
    tail_t = torch.complex(*torch.from_numpy(tail.reshape(2, 1, -1)))
    got = plain_variant(k.h, k.ct, tail_t, torch.from_numpy(xr), torch.from_numpy(xi), variant)
    tol = PFB_TOL if variant.startswith("pfb_") else B3_TOL
    scale = max(1.0, float(np.abs(want[0]).max()), float(np.abs(want[1]).max()))
    for g, w in zip(got, want):
        assert g.shape == (F, M)
        np.testing.assert_allclose(g.numpy(), w, atol=tol * scale)


def test_base_b3_is_k3(inputs):
    """base_b3's plain version is K3's, and the wrapper's default variant."""
    xr, xi, tail = (torch.from_numpy(a) for a in inputs)
    k = FusedPfbDft(M, K)
    tail_t = torch.complex(*tail.reshape(2, 1, -1))
    ref = plain_pfb_dft(k.h, tail_t, xr, xi)
    base = plain_variant(k.h, k.ct, tail_t, xr, xi, "base_b3")
    (yr, yi), new_tail = k.step_planes(tail_t, xr, xi)
    for a, b, c in zip(ref, base, (yr, yi)):
        assert torch.equal(a, b) and torch.equal(a, c)
    (_, _), tail_v = k.step_planes(tail_t, xr, xi, variant="batched_b3")
    assert torch.equal(tail_v, new_tail)
    assert k.launches == 0 and not any(k.variant_launches.values())


def test_batched_b3_is_the_dft():
    """The explicit CT product computes the FFT's DFT (FP32, to 1e-5 of scale)."""
    for m in (M, 4096):
        k = FusedPfbDft(m, K)
        rng = np.random.default_rng(m)
        x = torch.from_numpy(rng.standard_normal((2, 4 * m)).astype(np.float32))
        tail_t = torch.zeros((1, (K - 1) * m), dtype=torch.complex64)
        ref = plain_variant(k.h, k.ct, tail_t, x[0], x[1], "base_b3")
        got = plain_variant(k.h, k.ct, tail_t, x[0], x[1], "batched_b3")
        scale = float(torch.maximum(ref[0].abs().max(), ref[1].abs().max()))
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * scale)


def test_variant_guards(inputs):
    xr, xi, _ = (torch.from_numpy(a) for a in inputs)
    k = FusedPfbDft(M, K)
    with pytest.raises(ValueError, match="variant"):
        k.step_planes(k.init_state(1), xr, xi, variant="fast")
    with pytest.raises(ValueError, match="unsupported device"):
        k.step_planes(k.init_state(1), xr.to("meta"), xi.to("meta"), variant="dft_only")


# --- batched_b3 on the tensor cores: the 3xTF32 split, emulated ----------------------------


def test_tf32_round():
    """cvt.rna.tf32.f32: 10 mantissa bits, to nearest, ties away from zero."""
    one_ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1.0 + one_ulp / 2, 1.0 + one_ulp / 2 - 2 ** -23, -(1.0 + one_ulp / 2),
                      3.14159265, -2.5e-7], dtype=torch.float32)
    r = tf32_round(x)
    assert (r.view(torch.int32) & 0x1FFF).eq(0).all()
    assert r[0] == 1.0 and r[1] == 1.0 + one_ulp and r[2] == 1.0 and r[3] == -(1.0 + one_ulp)
    assert ((r - x).abs() <= x.abs() * 2.0 ** -11).all()


def _ct_case(m, frames, seed):
    k = FusedPfbDft(m, K)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((2, frames * m)).astype(np.float32))
    t = torch.from_numpy(rng.standard_normal((2, 1, (K - 1) * m)).astype(np.float32))
    return k, torch.complex(t[0], t[1]), x[0], x[1]


@pytest.mark.parametrize("m,frames", [(64, 16), (256, 8), (4096, 3)])
def test_batched_tf32_matches_plain(m, frames):
    """The kernel's arithmetic (3xTF32 products, FP32 twiddle) against
    batched_b3's plain version within 2e-4 of scale; a single TF32 product
    (1xTF32) is printed beside it and misses that bound, which is why the
    kernel splits."""
    k, tail, xr, xi = _ct_case(m, frames, m)
    want = plain_variant(k.h, k.ct, tail, xr, xi, "batched_b3")
    scale = float(torch.maximum(want[0].abs().max(), want[1].abs().max()))
    errs = {}
    for terms in (3, 1):
        got = plain_batched_tf32(k.h, k.ct, tail, xr, xi, terms=terms)
        errs[terms] = max(float((g - w).abs().max()) for g, w in zip(got, want)) / scale
    print(f"batched_b3 M={m}: 3xTF32 {errs[3]:.2e}, 1xTF32 {errs[1]:.2e} of scale "
          f"(bound {CT_TOL:.0e})")
    assert errs[3] <= CT_TOL / 10
    assert errs[1] > CT_TOL


def test_batched_tf32_matches_probe(probe, inputs):
    """The emulation against the probe's batched_b3 (bf16x3 on the MXU) in
    interpret mode, as test_variant_plain_matches_probe holds the plain
    version."""
    xr, xi, tail = inputs
    k = FusedPfbDft(M, K)
    M1, M2 = ct_factors(M)
    want = _probe_call(probe, "batched_b3", tail.reshape(2, K - 1, M1, M2), xr, xi, k.h.numpy())
    tail_t = torch.complex(*torch.from_numpy(tail.reshape(2, 1, -1)))
    got = plain_batched_tf32(k.h, k.ct, tail_t, torch.from_numpy(xr), torch.from_numpy(xi))
    scale = max(1.0, float(np.abs(want[0]).max()), float(np.abs(want[1]).max()))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _channel_order(w), atol=B3_TOL * scale)


def test_batched_card_shapes():
    """The tensor-core tiles take M2 = 128 and M1 a multiple of 16; the
    wrapper refuses other M on the card before it launches (the CPU takes
    any M)."""
    assert [ct_factors(m) for m in BATCHED_M] == [(16, 128), (32, 128), (64, 128)]
    k = FusedPfbDft(M, K)
    with pytest.raises(ValueError, match="batched_b3 on the card"):
        k._launch(k.init_state(1), torch.zeros(M * F), torch.zeros(M * F), "batched_b3")
