from spmv_scpa_tpu_torch.parallel.distributed import (
    RowShardedSpmv,
    make_mesh,
    plan_row_shards,
)

__all__ = ["RowShardedSpmv", "make_mesh", "plan_row_shards"]
