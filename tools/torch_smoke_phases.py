#!/usr/bin/env python3
"""``chip_smoke.py``'s wall time by phase, for this tree or another tree of
this repo (a parent unpacked by ``git archive``), so that two trees' runs
of the script can be compared phase by phase on one card.

    python3 tools/torch_smoke_phases.py [TREE]

Runs TREE's ``chip_smoke.main()`` (default: this tree's) and passes its
output through; a tree whose script clocks its phases (``clocked``) prints
the clock in its own ``chip_smoke_wall_s`` line. A tree from before the
clock gets this tree's clock around the kernel build and around each phase
function this tree's script clocks, and one more line after the script's
output: ``{"tree", "rc", "chip_smoke_wall_s", "phase_wall_s",
"outside_the_phases_s", "case_wall_s"}``. Exits with the script's code (1
where it raised).
"""

import ast
import importlib.util
import json
import os
import sys
import time
import traceback

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def clocked_names(path):
    """The top-level functions ``path``'s script decorates with
    ``@clocked``."""
    with open(path) as f:
        body = ast.parse(f.read()).body
    return [n.name for n in body if isinstance(n, ast.FunctionDef)
            and any(isinstance(d, ast.Name) and d.id == "clocked"
                    for d in n.decorator_list)]


def load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def main():
    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else HERE)
    # the tree's script and package first on the path, the script under
    # its own name: the mesh and pipeline phases' ranks import it so
    sys.path.insert(0, tree)
    cs = load(os.path.join(tree, "chip_smoke.py"), "chip_smoke")
    if hasattr(cs, "clocked"):
        return cs.main()
    clock = load(os.path.join(HERE, "chip_smoke.py"), "chip_smoke_clock")
    for name in clocked_names(os.path.join(HERE, "chip_smoke.py")):
        if hasattr(cs, name):
            setattr(cs, name, clock.clocked(getattr(cs, name)))
    from lifelong_clip_tpu_torch.ops import _kernels
    assert os.path.abspath(_kernels.__file__).startswith(tree)
    build = _kernels.build

    def timed_build():
        t0 = time.perf_counter()
        try:
            return build()
        finally:
            clock.PHASE_WALL_S["build"] = (clock.PHASE_WALL_S.get("build", 0.0)
                                           + time.perf_counter() - t0)

    _kernels.build = timed_build
    t0, rc = time.perf_counter(), 1
    try:
        rc = cs.main()
    except BaseException:
        traceback.print_exc()
    wall = time.perf_counter() - t0
    print(json.dumps({"tree": tree, "rc": rc, "chip_smoke_wall_s": wall,
                      "phase_wall_s": clock.PHASE_WALL_S,
                      "outside_the_phases_s":
                          wall - sum(clock.PHASE_WALL_S.values()),
                      "case_wall_s": clock.CASE_WALL_S}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
