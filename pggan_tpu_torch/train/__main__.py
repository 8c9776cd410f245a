"""python -m pggan_tpu_torch.train RUN_ID [--flags] (see `train/__init__.py`)."""

from pggan_tpu_torch.train import main

raise SystemExit(main())
