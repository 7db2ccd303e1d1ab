"""CLI: ``python -m su2_tpu_torch [--cpu] <config.cfg> [niter]`` (the
port's SU2_CFD).

Runs on the CUDA device with the hand-written kernels; without a visible
device it exits nonzero unless --cpu asks for the plain torch versions on
the CPU.  SU2_TPU_DTYPE=float64 selects double precision (default
float32).  Writes the convergence history file named by CONV_FILENAME.
"""

from su2_tpu_torch.driver import main

raise SystemExit(main())
