"""CLI: ``python -m su2_tpu_torch <config.cfg> [niter]`` (the port's SU2_CFD).

Runs on the GPU when torch sees one, else on the CPU with the kernels'
plain versions; SU2_TPU_DTYPE=float64 selects double precision (default
float32).  Writes the convergence history file named by CONV_FILENAME.
"""

from su2_tpu_torch.driver import main

raise SystemExit(main())
