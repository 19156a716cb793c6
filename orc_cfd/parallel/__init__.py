from orc_cfd.parallel.partition import (  # noqa: F401
    Partition,
    partition_mesh,
    rcb_partition,
)
from orc_cfd.parallel.sharded import (  # noqa: F401
    ShardedComm,
    gather_state,
    make_sharded_step,
    scatter_state,
    solve_steady_sharded,
)
