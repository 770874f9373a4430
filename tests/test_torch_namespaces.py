"""Every public name of each ``__init__.py`` of the JAX package imports
from the port's counterpart: the names its ``from ... import`` lines and
assignments bind (read from the source, so that a name the reference binds
is counted whether or not its module exports it elsewhere), each a class
where the reference's is a class and a function where it is a function."""
import ast
import importlib
import inspect
import pathlib

import pytest

import pycsou_tpu

ROOT = pathlib.Path(pycsou_tpu.__file__).parent
REPO = ROOT.parent


def _inits():
    return sorted(str(p.relative_to(ROOT.parent)) for p in ROOT.rglob("__init__.py"))


def _bound_names(path):
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return sorted(n for n in names if not n.startswith("_") or n == "__version__")


@pytest.mark.parametrize("init", _inits())
def test_reference_names_import_from_the_port(init):
    path = ROOT.parent / init
    ref_name = ".".join(pathlib.Path(init).parent.parts)
    port_name = ref_name.replace("pycsou_tpu", "pycsou_tpu_torch", 1)
    ref, port = importlib.import_module(ref_name), importlib.import_module(port_name)
    names = _bound_names(path)
    assert names, f"{init} binds no public name"
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, f"{port_name} lacks {missing}"
    for n in names:
        r, p = getattr(ref, n), getattr(port, n)
        assert inspect.isclass(r) == inspect.isclass(p), f"{port_name}.{n}: class in one package only"
        assert callable(r) == callable(p), f"{port_name}.{n}: callable in one package only"
        if not callable(r):
            assert r == p, f"{port_name}.{n} = {p!r}, the reference's {r!r}"
    # the port's own extras stay, and each name of its __all__ exists
    assert all(hasattr(port, n) for n in getattr(port, "__all__", ()))


def test_acceptance_imports():
    from pycsou_tpu_torch import LinearOperator
    from pycsou_tpu_torch.core import LinOpSum
    from pycsou_tpu_torch.kernels import tv_pds_stencil_step, tv_pds_stencil_step_xla
    from pycsou_tpu_torch.kernels.tv import tv_pds_stencil_step_plain
    from pycsou_tpu_torch.utils import lanczos_eigs, power_iteration
    from pycsou_tpu_torch.utils.opnorm import lanczos_eigs as le, power_iteration as pi

    assert issubclass(LinOpSum, LinearOperator)
    assert tv_pds_stencil_step_xla is tv_pds_stencil_step_plain
    assert tv_pds_stencil_step.__module__ == "pycsou_tpu_torch.kernels.tv"
    assert (power_iteration, lanczos_eigs) == (pi, le)


def test_port_keeps_its_top_level_extras():
    import pycsou_tpu_torch as p

    for n in ("APGD", "CPS", "DRS", "FBS", "PDS", "PMYULA", "LassoDeconvolution", "TVDeconvolution",
              "DistributedTVDeconv2D", "Mesh", "make_mesh", "get_default_device", "set_default_device"):
        assert n in p.__all__ and hasattr(p, n)


def _port_files():
    files = sorted((REPO / "pycsou_tpu_torch").rglob("*.py")) + sorted((REPO / "examples" / "torch").glob("*.py"))
    return [str(p.relative_to(REPO)) for p in files] + ["chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files())
def test_port_imports_neither_jax_nor_the_reference(path):
    """No module of the port, no example twin and ``chip_smoke.py`` import
    ``jax`` or ``pycsou_tpu`` (docstring examples included)."""
    src = (REPO / path).read_text()
    tree = ast.parse(src)
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    mods |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module and not n.level}
    for n in ast.walk(tree):  # doctest lines
        if isinstance(n, ast.Constant) and isinstance(n.value, str) and ">>>" in n.value:
            for line in n.value.splitlines():
                line = line.strip()
                if line.startswith(">>> import ") or line.startswith(">>> from "):
                    mods.add(line.split()[2].rstrip(","))
    top = {m.split(".")[0] for m in mods}
    assert not top & {"jax", "jaxlib", "pycsou_tpu"}, f"{path} imports {sorted(top & {'jax', 'pycsou_tpu'})}"
