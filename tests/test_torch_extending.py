"""``docs/TORCH.md`` runs end to end on the CPU, and its extending example
(the port's ``GraphGradient`` / ``GraphLaplacian``, taken from the page's
code) passes the four tests of ``tests/test_extending.py``, held to the
JAX graph operators defined there on the same numpy inputs: apply and
adjoint within rtol 1e-5, the power iteration on JAX's start vector within
rtol 1e-5, the Laplacian's matrix within 1e-5, and the graph-TV ``PDS``
iterates after 50 iterations within rtol 1e-4 / atol 1e-5 max|x|."""
import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pycsou_tpu.func as jfunc
import pycsou_tpu.func.penalty as jpen
import pycsou_tpu.opt as jopt
import pycsou_tpu.utils.opnorm as jopn
import pycsou_tpu_torch.utils.opnorm as topn
from pycsou_tpu_torch.utils.device import set_default_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOC = os.path.join(REPO, "docs", "TORCH.md")


@pytest.fixture(autouse=True)
def _on_cpu():
    """The CPU, on one thread: these runs are chains of small tensor ops,
    which several threads a test worker only slow down when the workers
    share the machine."""
    set_default_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    set_default_device(None)


def _blocks():
    return re.findall(r"```python\n(.*?)```", open(DOC).read(), flags=re.S)


def _graph_ops():
    """The page's first block (imports, ``dev``) and its graph operators."""
    blocks = _blocks()
    ns = {}
    exec(blocks[0], ns)
    exec(next(b for b in blocks if "class GraphGradient" in b), ns)
    return ns["GraphGradient"], ns["GraphLaplacian"]


def _jax_graph_ops():
    spec = importlib.util.spec_from_file_location("jax_extending", os.path.join(REPO, "tests", "test_extending.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.GraphGradient, mod.GraphLaplacian


def _ring_graph(n):
    return np.stack([np.arange(n), (np.arange(n) + 1) % n], axis=1)


def test_the_page_runs_on_the_cpu(capsys):
    ns = {}
    for block in _blocks():
        exec(block, ns)
    out = capsys.readouterr().out
    assert "TVDeconvolution plain" in out and "DistributedTVDeconv2D" in out
    assert ns["info"].converged and ns["graph_info"].n_iter > 0


def test_graph_gradient_dot_test(rng):
    TG, _ = _graph_ops()
    JG, _ = _jax_graph_ops()
    n = 24
    G, jG = TG(n, _ring_graph(n)), JG(n, _ring_graph(n))
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_allclose(float(torch.dot(G.apply(tx), ty)), float(torch.dot(tx, G.adjoint(ty))), rtol=1e-5)
    np.testing.assert_allclose(G.apply(tx).numpy(), np.asarray(jG.apply(jnp.asarray(x))), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(G.adjoint(ty).numpy(), np.asarray(jG.adjoint(jnp.asarray(y))), rtol=1e-5, atol=1e-6)
    assert G.lipschitz == pytest.approx(jG.lipschitz, rel=1e-12)


def test_graph_gradient_lipschitz_bound(monkeypatch):
    def draw(key, shape, dtype, device):
        v = jopn._rand_like(jax.random.PRNGKey(key), shape, jnp.float32)
        return torch.from_numpy(np.array(v)).to(dtype=dtype, device=device)

    monkeypatch.setattr(topn, "_rand_like", draw)
    TG, _ = _graph_ops()
    JG, _ = _jax_graph_ops()
    n = 24
    G, jG = TG(n, _ring_graph(n)), JG(n, _ring_graph(n))
    est, jest = G.compute_lipschitz_cst(), jG.compute_lipschitz_cst()
    assert est <= TG(n, _ring_graph(n)).lipschitz * (1 + 1e-4)
    np.testing.assert_allclose(est, 2.0, rtol=1e-2)  # the ring's gradient has norm 2
    np.testing.assert_allclose(est, jest, rtol=1e-5)


def test_graph_laplacian_matches_dense():
    TG, TL = _graph_ops()
    JG, JL = _jax_graph_ops()
    n = 16
    L = TL(TG(n, _ring_graph(n)))
    Ld = L.todense().mat.numpy()
    expect = 2 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    expect[0, -1] = expect[-1, 0] = -1
    np.testing.assert_allclose(Ld, expect, atol=1e-5)
    np.testing.assert_allclose(Ld, np.asarray(JL(JG(n, _ring_graph(n))).todense().mat), atol=1e-5)
    assert L.lipschitz == pytest.approx(4.0)


def test_graph_tv_denoising_with_generic_pds(rng):
    """The extension operator drives the stock PDS solver unchanged."""
    from pycsou_tpu_torch.func import L1Norm, SquaredL2Loss
    from pycsou_tpu_torch.opt import PDS

    TG, _ = _graph_ops()
    JG, _ = _jax_graph_ops()
    n = 32
    edges = _ring_graph(n)
    x_true = np.repeat([0.0, 1.0], n // 2).astype(np.float32)
    y = (x_true + 0.1 * rng.standard_normal(n)).astype(np.float32)
    kw = dict(max_iter=400, accuracy_threshold=1e-7, min_iter=50)
    solver = PDS((n,), F=SquaredL2Loss((n,), data=torch.from_numpy(y)), H=0.3 * L1Norm((n,)), K=TG(n, edges), **kw)
    jsolver = jopt.PDS((n,), F=jfunc.SquaredL2Loss((n,), data=jnp.asarray(y)), H=0.3 * jpen.L1Norm((n,)),
                       K=JG(n, edges), **kw)
    ts, js = solver.run_fixed(50), jsolver.run_fixed(50)
    for k in ("x", "z"):
        want = np.asarray(js[k])
        np.testing.assert_allclose(ts[k].numpy(), want, rtol=1e-4, atol=1e-5 * max(1.0, float(np.abs(want).max())))
    x = solver.solve()["x"].numpy()
    # graph TV flattens the noise within each constant segment
    assert np.abs(np.diff(x[3 : n // 2 - 3])).max() < 1e-3
    assert np.linalg.norm(x - x_true) < np.linalg.norm(y - x_true)
