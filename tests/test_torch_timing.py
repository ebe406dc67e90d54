"""``diag.timing.trace`` and ``ops.scans.first_order_iir`` against the JAX
package's.

``trace``: the port's (torch.profiler) and the reference's (jax.profiler),
each around a small op of its own package and writing into its own
directory, both yield that directory and both leave a gzipped Chrome trace
at ``plugins/profile/<stamp>/<host>.trace.json.gz`` whose JSON holds a
non-empty ``traceEvents`` list; the port's names an ``aten::`` op. A body
that raises still leaves its trace, and a CUDA device on a machine with no
card is refused.

``first_order_iir``: seeded (3, 257) inputs, real and complex, poles 0.0,
0.5 and 0.999, within 1e-5 relative plus 1e-6 absolute (both packages run
a log-step scan, in different orders of summation)."""

import gzip
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radioframe.diag import timing as jtiming
from radioframe.ops import scans as jscans
from radioframe_torch.diag import timing as ttiming
from radioframe_torch.ops import scans as tscans


def _trace_events(log_dir) -> list:
    """The traceEvents of the one trace under ``log_dir``."""
    files = list(log_dir.glob("plugins/profile/*/*.trace.json.gz"))
    assert len(files) == 1, files
    with gzip.open(files[0], "rt") as f:
        doc = json.load(f)
    assert isinstance(doc, dict)
    return doc["traceEvents"]


def test_trace_writes_the_reference_layout(tmp_path):
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    with jtiming.trace(str(jdir)) as d:
        assert d == str(jdir)
        (jnp.ones((8, 8)) @ jnp.ones((8, 8))).block_until_ready()
    with ttiming.trace(str(tdir), device="cpu") as d:
        assert d == str(tdir)
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert _trace_events(jdir)
    events = _trace_events(tdir)
    assert any(str(e.get("name", "")).startswith("aten::") for e in events)


def test_trace_is_written_when_the_body_raises(tmp_path):
    with pytest.raises(KeyError, match="body"):
        with ttiming.trace(str(tmp_path), device="cpu"):
            torch.ones(4) + 1
            raise KeyError("body")
    assert _trace_events(tmp_path)


def test_trace_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with ttiming.trace(str(tmp_path), device="cuda"):
            pass
    assert not (tmp_path / "plugins").exists()


@pytest.mark.parametrize("pole", [0.0, 0.5, 0.999])
@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_first_order_iir_matches_jax(dtype, pole):
    rng = np.random.default_rng(13)

    def draw(shape):
        x = rng.standard_normal(shape)
        if dtype == np.complex64:
            x = x + 1j * rng.standard_normal(shape)
        return x.astype(dtype)

    x, b, s0 = draw((3, 257)), draw((3, 257)), draw(3)
    want = np.asarray(jscans.first_order_iir(jnp.asarray(x), pole, jnp.asarray(b),
                                             jnp.asarray(s0)))
    got = tscans.first_order_iir(torch.from_numpy(x), pole, torch.from_numpy(b),
                                 torch.from_numpy(s0)).numpy()
    assert got.dtype == want.dtype == dtype
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
