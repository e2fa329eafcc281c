"""Method registry (reference main.py:25-40 + methods/__init__.py:19-32)."""

from __future__ import annotations


def get_method(name: str):
    from .adapter_clip import AdapterCLIP
    from .clib import CLIB
    from .continual_clip import ContinualCLIP
    from .er_baseline import ER, FT
    from .ewcpp import EWCpp
    from .lwf import LwF
    from .maple import MaPLe
    from .mvp_clip import CLIP_MVP
    from .proto_clip import Trainer_ProtoCLIP
    from .rainbow_memory import RM
    from .vit_prompt_methods import MVP, DualPrompt, L2P

    registry = {"continual-clip": ContinualCLIP, "lora-clip": AdapterCLIP,
                "adapter-clip": AdapterCLIP, "moe-clip": AdapterCLIP,
                "mvp-clip": CLIP_MVP, "maple": MaPLe,
                "adapter-clip-proto_prompt": Trainer_ProtoCLIP,
                "template": Trainer_ProtoCLIP,
                "l2p": L2P, "dualprompt": DualPrompt, "mvp": MVP,
                "er": ER, "Finetuning": FT, "lwf": LwF, "ewc++": EWCpp,
                "clib": CLIB, "rm": RM}
    if name not in registry:
        raise NotImplementedError(
            f"method {name!r} not available; have: {sorted(registry)}")
    return registry[name]
