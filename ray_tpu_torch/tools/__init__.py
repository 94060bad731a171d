"""Tools of ray_tpu_torch: the static analyzer (`tools.lint`)."""
