"""Typed configuration for models, PEFT, streams, and training.

The reference drives everything through a flat argparse namespace
(``configuration/config.py:4-117``); here the same knobs live in typed
dataclasses, with the CLI layer (``lifelong_clip_tpu_torch/main.py``) mapping
flag-compatible argument names onto them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    """Architecture hyperparameters for a CLIP image+text tower pair."""
    embed_dim: int = 512
    # vision tower
    image_size: int = 224
    patch_size: int = 16
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    # text tower
    context_length: int = 77
    vocab_size: int = 49408
    text_width: int = 512
    text_heads: int = 8
    text_layers: int = 12
    # tower variant knobs: CLIP uses QuickGELU + a pre-transformer LN;
    # timm/AugReg ViTs use exact GELU and no ln_pre
    act: str = "quick_gelu"        # quick_gelu | gelu
    use_ln_pre: bool = True
    # visual tower family: "vit" (transformer) or "rn" (ModifiedResNet,
    # reference model.py:113-191). For "rn", vision_layers is a 4-tuple of
    # stage depths, vision_width the stem width, and vision_heads the
    # attention-pool head count (width * 32 // 64, model.py:808).
    tower: str = "vit"

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def vision_seq_len(self) -> int:
        return self.grid_size * self.grid_size + 1  # + CLS


# Presets matching the OpenAI checkpoint family (shapes inferred by the
# reference at models/clip/model.py:1005-1044).
CLIP_PRESETS = {
    "ViT-B/16": CLIPConfig(),
    "ViT-B/32": dataclasses.replace(CLIPConfig(), patch_size=32),
    "ViT-L/14": CLIPConfig(embed_dim=768, patch_size=14, vision_width=1024,
                           vision_layers=24, vision_heads=16, text_width=768,
                           text_heads=12, text_layers=12),
    # timm-style ViT-B/16 (the reference's L2P/DualPrompt/MVP backbone,
    # models/l2p.py:23-31): exact GELU, no ln_pre; text tower unused
    "vit_base_patch16_224": dataclasses.replace(
        CLIPConfig(), embed_dim=768, act="gelu", use_ln_pre=False),
    # ModifiedResNet family (reference model.py:113-191; shapes per the
    # OpenAI checkpoints the reference loader names at clip_loader.py:20-31)
    "RN50": CLIPConfig(embed_dim=1024, image_size=224, vision_width=64,
                       vision_layers=(3, 4, 6, 3), vision_heads=32,
                       text_width=512, text_heads=8, text_layers=12,
                       tower="rn"),
    "RN101": CLIPConfig(embed_dim=512, image_size=224, vision_width=64,
                        vision_layers=(3, 4, 23, 3), vision_heads=32,
                        text_width=512, text_heads=8, text_layers=12,
                        tower="rn"),
    "RN50x4": CLIPConfig(embed_dim=640, image_size=288, vision_width=80,
                         vision_layers=(4, 6, 10, 6), vision_heads=40,
                         text_width=640, text_heads=10, text_layers=12,
                         tower="rn"),
    "RN50x16": CLIPConfig(embed_dim=768, image_size=384, vision_width=96,
                          vision_layers=(6, 8, 18, 8), vision_heads=48,
                          text_width=768, text_heads=12, text_layers=12,
                          tower="rn"),
    # Toy tower for CLI smoke runs / debugging (no reference counterpart;
    # the reference's only smoke mode is --debug sample truncation,
    # methods/_trainer.py:343-344 — it cannot shrink the model itself).
    # Deep enough that DualPrompt's e-prompt layers (2,3,4) and MaPLe's
    # depth-3 compound replacement actually place.
    "debug-tiny": CLIPConfig(embed_dim=64, image_size=32, patch_size=8,
                             vision_width=64, vision_layers=6,
                             vision_heads=4, text_width=64, text_heads=4,
                             text_layers=3),
    "RN50x64": CLIPConfig(embed_dim=1024, image_size=448, vision_width=128,
                          vision_layers=(3, 15, 36, 10), vision_heads=64,
                          text_width=1024, text_heads=16, text_layers=12,
                          tower="rn"),
}


def resolve_clip_preset(model_name: str) -> CLIPConfig:
    """Accept either a preset key or a checkpoint path containing one."""
    if model_name in CLIP_PRESETS:
        return CLIP_PRESETS[model_name]
    for key, cfg in CLIP_PRESETS.items():
        fname = key.replace("/", "-")  # e.g. ViT-B-16.pt
        if fname in model_name or key in model_name:
            return cfg
    raise KeyError(f"cannot infer CLIP architecture from {model_name!r}; "
                   f"known presets: {list(CLIP_PRESETS)}")


@dataclasses.dataclass(frozen=True)
class PEFTConfig:
    """Which parameter-efficient pieces are injected into the towers.

    Mirrors the reference ``design_details`` dict consumed at
    ``models/clip/model.py:639-683``, but resolved at trace time into
    optional parameter subtrees rather than module-class swaps.
    """
    method: str = "none"  # none | lora | adapter | moe | prefix | maple | mvp
    encoder: str = "image"  # none | image | text | both
    lora_r: int = 4
    lora_alpha: int = 1
    adapter_dim: int = 64        # reference 'ffn_num'
    adapter_scale: float = 0.1
    moe_experts: int = 2
    moe_top_k: int = 2
    moe_noisy_gating: bool = True
    prefix_len: int = 8
    # prompt-based methods
    n_ctx: int = 12
    num_prompt: int = 10
    top_k_prompt: int = 2
    prompt_depth: int = 3        # MaPLe compound prompt depth

    def on_vision(self) -> bool:
        return self.method != "none" and self.encoder in ("image", "both")

    def on_text(self) -> bool:
        return self.method != "none" and self.encoder in ("text", "both")


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Si-Blurry stream protocol knobs (reference utils/online_sampler.py)."""
    n_tasks: int = 5
    n: int = 50          # % disjoint classes
    m: int = 10          # % blurry samples shuffled across tasks
    rnd_NM: bool = False
    seed: int = 1


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    method: str = "lora-clip"
    dataset: str = "cifar100"
    model_name: str = "ViT-B/16"
    pretrained_path: Optional[str] = None
    batchsize: int = 64
    test_batchsize: int = 64
    online_iter: float = 3.0
    temp_batchsize: int = 0
    lr: float = 5e-4
    opt_name: str = "adamw"
    sched_name: str = "default"
    memory_size: int = 0
    eval_period: int = 1000
    topk: int = 1
    # regularization / memory-method knobs (reference config.py:57,77,83)
    reg_coef: float = 100.0      # EWC++ penalty weight
    memory_epoch: int = 0        # Rainbow Memory post-task epochs
    # Rainbow Memory MC-uncertainty memory rebuild at task boundaries.
    # OFF by default: the reference ships uncertainty_sampling()/
    # montecarlo() as DEAD code (rainbow_memory.py:177-285 — no call
    # site anywhere; its live update_memory is class-balanced random
    # replacement), so the default mirrors the live reference. The
    # machinery is a documented capability add behind this flag.
    rm_uncertainty: bool = False
    imp_update_period: int = 1   # CLIB importance-update cadence
    # CLIB adaptive-LR knobs (reference config.py:78-80)
    lr_step: float = 0.95
    lr_length: int = 10
    lr_period: int = 10
    # epochs per task (reference --epochNum, default 6 there; the online
    # protocol default here is one pass per task)
    epoch_num: int = 1
    # class-name prompt template (reference --text_template)
    text_template: str = "a bad photo of a {}."
    # The reference AdapterCLIP wrapper returns SOFTMAXED probs and the
    # trainer applies CrossEntropyLoss on top (models/adapter_clip.py:94-100
    # + methods/adapter_clip.py:87-89) — an evident quirk, but the shipped
    # training math the paper's lora/adapter numbers come from. True (the
    # default) mirrors it for the adapter-clip family; False trains plain
    # CE on logits.
    ce_on_probs: bool = True
    visible_classes: str = "batch"   # batch | all
    peft: PEFTConfig = dataclasses.field(default_factory=PEFTConfig)
    stream: StreamConfig = dataclasses.field(default_factory=StreamConfig)
    transforms: Tuple[str, ...] = ("cutmix", "autoaug")
    use_bf16: bool = True
    data_dir: str = "./data"
    log_path: str = "results"
    note: str = ""
    debug: bool = False
    # device mesh: (data, model) axis sizes; model=1 -> pure DP
    mesh_shape: Tuple[int, int] = (1, 1)
    # fixed-capacity class vocabulary for jit-stable logits
    max_classes: int = 0  # 0 -> derived from dataset
    n_worker: int = 0
    seed: int = 1
    profile: bool = False
    # force activation rematerialization in the train step (auto-enabled
    # at batchsize >= 256, where the un-remat'd step exceeds HBM)
    remat: bool = False
    ckpt_dir: str = ""       # save resume checkpoints at task boundaries
    resume_from: str = ""    # restore a run from this checkpoint dir
    # torch device the towers run on: "cuda" (default; raises when no GPU
    # is present) or "cpu" (the kernels' plain versions)
    device: str = "cuda"
