"""Datasources of the port (``gofr_tpu/datasource``): the device
datasource, ``tpu``, and SQL, ``sql`` (sqlite, and the Postgres and MySQL
wire clients). The Redis, KV, file, document and networked-broker ones
are not ported (ROADMAP Queue A item 11)."""
