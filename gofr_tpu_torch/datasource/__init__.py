"""Datasources of the port (``gofr_tpu/datasource``): the device
datasource, ``tpu``. The SQL, Redis, file and networked-broker ones are
not ported (ROADMAP Queue A items 10–11)."""
