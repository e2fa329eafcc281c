"""Method registry (reference main.py:25-40 + methods/__init__.py:19-32)."""

from __future__ import annotations


def get_method(name: str):
    from .adapter_clip import AdapterCLIP
    from .continual_clip import ContinualCLIP
    from .maple import MaPLe
    from .mvp_clip import CLIP_MVP
    from .proto_clip import Trainer_ProtoCLIP
    from .vit_prompt_methods import MVP, DualPrompt, L2P

    registry = {"continual-clip": ContinualCLIP, "lora-clip": AdapterCLIP,
                "adapter-clip": AdapterCLIP, "moe-clip": AdapterCLIP,
                "mvp-clip": CLIP_MVP, "maple": MaPLe,
                "adapter-clip-proto_prompt": Trainer_ProtoCLIP,
                "template": Trainer_ProtoCLIP,
                "l2p": L2P, "dualprompt": DualPrompt, "mvp": MVP}
    if name not in registry:
        raise NotImplementedError(
            f"method {name!r} is not ported to the PyTorch package yet; have: "
            f"{sorted(registry)} (the JAX package lifelong_clip_tpu has all "
            "16; the port's order is in ROADMAP.md, queue A)")
    return registry[name]
