"""User-facing wrappers (Gymnasium-style, MuJoCo), counterpart of
``exciting_environments_tpu/wrappers``."""
