"""The benchmark of stjep_tpu_torch: its harness, yardstick and plain reference."""
