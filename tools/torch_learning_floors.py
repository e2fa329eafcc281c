#!/usr/bin/env python3
"""The learning gates' starting trees, and their seed sweep.

    python tools/torch_learning_floors.py write
    python tools/torch_learning_floors.py seeds maple --seeds 1-13 \
        [--package port|jax|both]

``write``: builds each JAX trainer of ``tests/test_learning_quality.py``
as that test does (seed 1) and writes its starting trees to
``tests/data/learning_gate_start.npz``: the frozen tower once (every case
draws the same one: an assertion), each case's trainable tree under its
method's name, and of the token table only the rows the port's runs read
(``token_rows``: the ids its tokenizer gives, SOT, EOT and the padding id
0). Then runs each port case from the file (``tests/torch_learning_gates.py:
gate_run``, every other token row NaN) and from the whole tower, and
checks the two runs give the same result; prints the port's and JAX's
A_last / A_auc.

``seeds``: a case's A_last / A_auc on each package's own draws at each
seed of the range (the port: ``own_init_run``; JAX: the test's
``family_gate_run`` or the ER test's config): how often a draw lands
under the floors.

Runs on the CPU (both packages); imports JAX, so it is a tool beside the
tests, never part of the port.
"""

import argparse
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))


def _jax():
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    return jax


def jax_trainer(gate, log_path, seed=1):
    """The JAX trainer of ``gate`` as ``tests/test_learning_quality.py``
    builds it (the ER test's config, or ``family_gate_run``'s)."""
    from test_engine import tiny_cfg
    from test_sharding import _tiny_trainer_for
    from lifelong_clip_tpu.data.registry import make_synthetic
    cls, kw = _tiny_trainer_for(gate.method)
    kw.update(dict(gate.flags))
    cfg = tiny_cfg(method=gate.method, online_iter=gate.online_iter,
                   lr=gate.lr, log_path=log_path, seed=seed, **kw)
    train = make_synthetic(n_classes=8, per_class=64, image_size=32, seed=0)
    test = make_synthetic(n_classes=8, per_class=8, image_size=32, seed=0,
                          train=False)
    return cls(cfg, train_dataset=train, test_dataset=test)


def names(tree):
    """{"a/b/c": leaf} of a nested dict: ``START``'s names."""
    import torch_learning_gates as lg
    return {"/".join(k): v for k, v in lg.flat(tree).items()}


def write(tmp):
    jax = _jax()
    import pytest
    import torch
    import torch_learning_gates as lg
    from lifelong_clip_tpu_torch.bridge import params_from_numpy
    from lifelong_clip_tpu_torch.utils import tokenizer
    torch.set_num_threads(1)
    frozen, arrays, jax_out = None, {}, {}
    for name, gate in lg.GATES.items():
        tr = jax_trainer(gate, os.path.join(tmp, "jax"))
        tower = names(jax.tree.map(np.asarray, tr.params))
        if frozen is None:
            frozen = tower
        assert tower.keys() == frozen.keys()
        assert all(np.array_equal(tower[k], frozen[k]) for k in frozen), \
            f"{name} draws another frozen tower"
        for k, v in names(jax.tree.map(np.asarray,
                                       tr.state.trainable)).items():
            arrays[f"{name}/{k}"] = v
        jax_out[name] = tr.run()
    # the token rows the port's runs read, from the whole tower
    tk = tokenizer.default_tokenizer()
    ids = {0, tk.sot, tk.eot}
    real = tokenizer.ClipTokenizer.encode

    def encode(self, text):
        out = real(self, text)
        ids.update(out)
        return out

    whole = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tokenizer.ClipTokenizer, "encode", encode)
        for name, gate in lg.GATES.items():
            cls = lg.trainer_class(gate)
            train, test = lg.data()
            with pytest.MonkeyPatch.context() as mp2:
                lg.patch_build(mp2, cls, lambda *a, device=None, **kw: (
                    params_from_numpy(lg.nest(frozen), device or "cpu"),
                    lg.TINY))
                t = cls(lg.config(gate, os.path.join(tmp, "whole")),
                        train_dataset=train, test_dataset=test)
                lg.copy_trainable(lg.nest({
                    k[len(name) + 1:]: v for k, v in arrays.items()
                    if k.startswith(name + "/")}), t)
                whole[name] = t.run()
    rows = np.array(sorted(ids), np.int64)
    out = {f"frozen/{k}": v for k, v in frozen.items()}
    out["frozen/text/token_embedding"] = \
        frozen["text/token_embedding"][rows]
    out[lg.ROWS] = rows
    out.update(arrays)
    os.makedirs(os.path.dirname(lg.START), exist_ok=True)
    np.savez_compressed(lg.START, **out)
    print(f"wrote {os.path.relpath(lg.START, REPO)}: "
          f"{os.path.getsize(lg.START)} bytes, {len(rows)} token rows")
    for name, gate in lg.GATES.items():
        got = lg.gate_run(gate, os.path.join(tmp, "file"))
        assert got == whole[name], (name, got, whole[name])
        print(f"{name}: port A_last {got['A_last']:.4f}, A_auc "
              f"{got['A_auc']:.4f} (floors {gate.last_floor}, "
              f"{gate.auc_floor}); JAX A_last "
              f"{jax_out[name]['A_last']:.4f}, A_auc "
              f"{jax_out[name]['A_auc']:.4f} (the test's measured "
              f"{gate.healthy})")


def seeds(method, lo, hi, package, tmp):
    import torch
    import torch_learning_gates as lg
    torch.set_num_threads(1)
    gate = lg.GATES[method]
    for seed in range(lo, hi + 1):
        for pkg in ("port", "jax"):
            if package not in (pkg, "both"):
                continue
            if pkg == "port":
                out = lg.own_init_run(gate, os.path.join(tmp, "port"), seed)
            else:
                _jax()
                out = jax_trainer(gate, os.path.join(tmp, "jax"),
                                  seed).run()
            low = out["A_last"] <= gate.last_floor or \
                out["A_auc"] <= gate.auc_floor
            print(f"{method} {pkg} seed {seed}: A_last {out['A_last']:.4f}"
                  f", A_auc {out['A_auc']:.4f}"
                  + (" (under a floor)" if low else ""), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("write")
    sp = sub.add_parser("seeds")
    sp.add_argument("method")
    sp.add_argument("--seeds", default="1-13")
    sp.add_argument("--package", default="both",
                    choices=("port", "jax", "both"))
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        if args.cmd == "write":
            write(tmp)
        else:
            lo, hi = map(int, args.seeds.split("-"))
            seeds(args.method, lo, hi, args.package, tmp)


if __name__ == "__main__":
    main()
