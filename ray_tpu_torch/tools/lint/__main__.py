"""`python -m ray_tpu_torch.tools.lint ray_tpu_torch/` — the CI gate entry point."""

from ray_tpu_torch.tools.lint.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
