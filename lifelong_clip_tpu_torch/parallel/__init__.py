"""Device meshes on ``torch.distributed`` (``parallel/mesh.py``)."""
