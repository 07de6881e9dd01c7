"""lorastencil: a low-rank stencil computation framework in JAX.

Re-implements the capabilities of the LoRAStencil SC'24 artifact
(stencils as low-rank separable terms plus a sparse residue) for NVIDIA
GPUs: a plain ``jax.numpy`` step that XLA compiles, a fused-timestep
CUDA kernel for 2-D stencils called through JAX's foreign function
interface, lax loops for timestepping, and shard_map + ppermute domain
decomposition for multi-device grids.
"""

from .models.shapes import ALL_SHAPES, StencilSpec, SeparableTerm, get_shape

__version__ = "0.1.0"
__all__ = ["ALL_SHAPES", "StencilSpec", "SeparableTerm", "get_shape"]
