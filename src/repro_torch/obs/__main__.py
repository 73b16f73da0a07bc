"""Entry point for ``python -m repro_torch.obs report <run_dir>``."""

from repro_torch.obs.report import main

if __name__ == "__main__":
    raise SystemExit(main())
