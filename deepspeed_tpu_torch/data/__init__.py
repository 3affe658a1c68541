"""The input data path (counterpart of ``deepspeed_tpu/data/``):
deterministic sharded streaming, sequence packing and background prefetch
to the card.

* :class:`ShardedSampleStream` — deterministic, seed+epoch-keyed sample
  order, disjointly sharded across data-parallel ranks, resumable via
  ``state_dict``.
* :class:`SequencePacker` — greedy first-fit bin packing of variable
  length documents into fixed ``[B, S]`` batches with ``segment_ids`` and
  per-segment position resets (the model's same-segment attention and
  loss weights complete the exactness contract).
* :class:`DevicePrefetcher` — a bounded background queue whose worker runs
  the engine's transfer (pinned host memory, a CUDA stream of its own), so
  the copy of batch N+1 overlaps the step of batch N.
* :class:`PackedDataPipeline` — the loader-protocol object tying the
  stream and packer together (``state_dict``/``load_state_dict``/
  ``reseed``/``order_version``, the ``DeepSpeedDataLoader`` contract).

Selected by the ``data_pipeline`` config block (``runtime/config.py``),
off by default: without it ``deepspeed_io`` builds ``DeepSpeedDataLoader``.
The three numpy modules are copies of the JAX package's, kept in the port
so that it never imports ``deepspeed_tpu``.
"""

from deepspeed_tpu_torch.data.packing import SequencePacker, pack_documents
from deepspeed_tpu_torch.data.pipeline import PackedDataPipeline
from deepspeed_tpu_torch.data.prefetch import DevicePrefetcher
from deepspeed_tpu_torch.data.streaming import ShardedSampleStream

__all__ = [
    "DevicePrefetcher",
    "PackedDataPipeline",
    "SequencePacker",
    "ShardedSampleStream",
    "pack_documents",
]
