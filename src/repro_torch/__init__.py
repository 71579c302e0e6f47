"""PyTorch/CUDA port of ``repro`` for one NVIDIA Hopper GPU (H100, sm_90a).

The JAX package ``repro`` is the reference; this package mirrors its layout
and names so each module has an obvious counterpart.  It imports ``torch``
and numpy, never ``jax`` and nothing of ``repro``.

Layouts at every public function are the reference's: activations NHWC,
weights RSCK, conv outputs NPQK.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; without a GPU and without an explicit
device they raise (``repro_torch.backend.resolve_device``).

Importing the package builds nothing: the CUDA kernels compile with
``nvcc`` at their first launch (``repro_torch.kernels._build``).
"""
