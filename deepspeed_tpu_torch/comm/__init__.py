"""deepspeed_tpu_torch.comm: collectives over ``torch.distributed`` (the
exports of ``deepspeed_tpu/comm/__init__.py``)."""

from deepspeed_tpu_torch.comm.comm import (  # noqa: F401
    ReduceOp,
    all_gather,
    all_gather_object,
    all_reduce,
    all_to_all_single,
    axis_index,
    barrier,
    broadcast,
    broadcast_object,
    destroy_distributed,
    get_backend,
    get_local_device_count,
    get_local_rank,
    get_rank,
    get_world_size,
    host_group,
    index_group,
    init_distributed,
    is_initialized,
    log_summary,
    ppermute,
    reduce_scatter,
    send_recv_next,
    send_recv_prev,
    warm_up,
)
from deepspeed_tpu_torch.comm.logging import CommsLogger, comms_logger  # noqa: F401
