"""Weight bridge between the JAX package's parameter pytrees and the port.

The JAX trees (``models/init.py:init_clip_params``, ``models/peft.py:
init_lora``) are nested dicts whose transformer blocks are layer-stacked with
a leading L axis; weights keep the ``x @ W`` orientation (``w_qkv`` (D, 3D),
``w_out`` (D, D); LoRA ``a_in`` (L, D, r), ``b_in`` (L, r, 3D), ``a_out``
(L, D, r), ``b_out`` (L, r, D)). The port uses the same layout, so the bridge
only converts leaves. The method trees go through it the same way: the
prompt pools and heads of L2P and DualPrompt (``pool``/``g_pool``/
``e_pool`` {``key``, ``prompts``}, ``head`` {``w``, ``b``}), the MVP(ViT)
tree and ProtoCLIP's (``text_key``, ``text_prompt``, ``copl`` {``p``,
``k``, ``a``}). The ModifiedResNet vision tree (``models/resnet.py``)
keeps JAX's layout too (HWIO kernels, its stages and blocks as lists, a
missing ``downsample`` as None), so it crosses the same way. It takes
nested dicts and lists of numpy arrays (convert a JAX tree with
``jax.tree.map(np.asarray, tree)``) and never sees JAX itself.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device="cpu", dtype=None):
    """Nested dicts and lists of numpy arrays (or scalars) -> the same of
    tensors. ``dtype`` casts floating leaves; ``None`` keeps each leaf's
    dtype (bfloat16 leaves from ``ml_dtypes`` arrive as torch.bfloat16)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device, dtype) for v in tree]
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_to_numpy(tree):
    """Nested dicts and lists of tensors -> numpy (bf16 leaves become
    float32)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
