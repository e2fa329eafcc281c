"""Every port test file takes its worker's share of the cores
(``tests/torch_threads.py``): none may run torch's CPU pool on every core
beside five other workers doing the same."""

import torch_threads  # noqa: F401  (the worker's share of the cores)

import ast
import glob
import os

import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def _imports_helper(path):
    tree = ast.parse(open(path).read(), path)
    return any(isinstance(node, ast.Import)
               and any(a.name == "torch_threads" for a in node.names)
               for node in tree.body)


def test_every_port_test_file_imports_the_thread_share():
    files = sorted(glob.glob(os.path.join(HERE, "test_torch_*.py")))
    assert len(files) > 40
    missing = [os.path.basename(f) for f in files if not _imports_helper(f)]
    assert not missing, f"import torch_threads missing in {missing}"


def test_thread_share_is_the_cores_over_the_workers():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    assert torch_threads.SHARE == max(1, (os.cpu_count() or 1) // workers)
    assert torch.get_num_threads() == torch_threads.SHARE
