"""Multi-device parallelism: sequence-batched VIO over a device mesh and the
distributed solver shardings (SURVEY.md §2.3)."""

from .sharded import (  # noqa: F401
    make_mesh,
    make_batch_problem,
    sharded_batch_solve,
)
from .multi_seq import MultiSequenceSolver  # noqa: F401
