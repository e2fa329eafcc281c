"""Method registry (reference main.py:25-40 + methods/__init__.py:19-32)."""

from __future__ import annotations


def get_method(name: str):
    from .adapter_clip import AdapterCLIP

    registry = {"lora-clip": AdapterCLIP}
    if name not in registry:
        raise NotImplementedError(
            f"method {name!r} is not ported to the PyTorch package yet; have: "
            f"{sorted(registry)} (the JAX package lifelong_clip_tpu has all "
            "16; the port's order is in ROADMAP.md, queue A)")
    return registry[name]
