"""Block-sparse attention (counterpart of ``deepspeed_tpu/ops/sparse_attention``):
the SparsityConfig family, the block-sparse kernels (B5-B7, through
``ops/cuda/block_sparse_attention.py``), the gather and dense
implementations, and ``SparseSelfAttention``, which routes between them."""

from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (  # noqa: F401
    SparsityConfig,
    DenseSparsityConfig,
    FixedSparsityConfig,
    VariableSparsityConfig,
    BigBirdSparsityConfig,
    BSLongformerSparsityConfig,
    LocalSlidingWindowSparsityConfig,
)
from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import (  # noqa: F401
    SparseSelfAttention,
    block_sparse_attention,
    dense_blocksparse_attention,
    gathered_blocksparse_attention,
)
