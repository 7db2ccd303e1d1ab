"""io layer of su2_tpu_torch."""
