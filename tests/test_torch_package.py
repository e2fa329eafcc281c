"""Package-level checks of the PyTorch port: no JAX anywhere in it, the CLI
end to end on the CPU, and the refusals of what is not ported."""

import ast
import os

import pytest
import torch

from lifelong_clip_tpu_torch import main as cli
from lifelong_clip_tpu_torch.device import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "lifelong_clip_tpu_torch")
TINY_ARGS = ["--model_name", "debug-tiny", "--dataset", "synthetic-10x8",
             "--n_tasks", "2", "--batchsize", "8", "--test_batchsize", "8",
             "--eval_period", "32"]


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, fs in os.walk(PKG):
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    return files


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = _port_files()
    assert len(files) > 20
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax",
                               "lifelong_clip_tpu"), (path, mod)


def test_cli_cpu_run_writes_result(tmp_path):
    out = cli.main(TINY_ARGS + ["--device", "cpu", "--transforms",
                                "--log_path", str(tmp_path)])
    assert set(out) == {"A_auc", "A_avg", "A_last", "F_last"}
    found = [os.path.join(d, "result.txt") for d, _, fs in os.walk(tmp_path)
             if "result.txt" in fs]
    assert len(found) == 1
    first = open(found[0]).read().splitlines()[0]
    assert first.startswith("Dataset:synthetic-10x8 | A_auc ")


@pytest.mark.parametrize("extra", [
    ["--transforms", "autoaug"],
    ["--transforms", "--method", "continual-clip"],
    ["--transforms", "--mesh", "2x1"],
])
def test_unported_parts_raise(tmp_path, extra):
    with pytest.raises(NotImplementedError):
        cli.main(TINY_ARGS + ["--device", "cpu", "--log_path",
                              str(tmp_path)] + extra)


def test_default_device_raises_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(TINY_ARGS + ["--transforms", "--log_path", str(tmp_path)])
    assert resolve_device("cpu").type == "cpu"
