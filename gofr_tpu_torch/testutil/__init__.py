"""Test doubles of the port (copies of ``gofr_tpu/testutil`` modules that
raise the port's errors)."""
