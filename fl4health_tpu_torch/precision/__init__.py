"""Engine-level mixed-precision policy (counterpart of
``fl4health_tpu/precision``): a ``PrecisionConfig`` says how every client
trains; the engine casts at model apply time and keeps f32 master
weights."""

from fl4health_tpu_torch.precision.policy import (PrecisionConfig, cast_floats,
                                                  conv_compute_dtype, loss_scale_init,
                                                  loss_scale_step, tree_all_finite,
                                                  wrap_logic_compute)

__all__ = ["PrecisionConfig", "cast_floats", "conv_compute_dtype", "loss_scale_init",
           "loss_scale_step", "tree_all_finite", "wrap_logic_compute"]
