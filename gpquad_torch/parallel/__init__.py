"""Scale-out over ``torch.distributed`` (port of ``gpquad/parallel``):
data-parallel points, probe-parallel traces, pencil-sharded frequency
grids.  gpquad's double-word ``make_msharded_toeplitz_df_apply`` is not
re-created: the port's high tier runs the pencil in complex128."""
from .msharded import (make_msharded_A_mean, make_msharded_toeplitz_apply,
                       msharded_fit, msharded_fit_high, msharded_gradient,
                       msharded_predict_var, msharded_toeplitz_matvec,
                       shard_toeplitz_kernel)
from .sharding import (make_mesh, replicate, shard_points, shard_probes,
                       sharded_fit, sharded_gradient, sharded_pg_outer_step)

__all__ = ["make_mesh", "replicate", "shard_points", "shard_probes",
           "sharded_fit", "sharded_gradient", "sharded_pg_outer_step",
           "msharded_toeplitz_matvec", "shard_toeplitz_kernel",
           "make_msharded_A_mean", "msharded_fit", "msharded_gradient",
           "msharded_predict_var", "msharded_fit_high"]
