"""The benchmark's driver, metrics, trace and output check."""
