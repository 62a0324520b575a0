"""Datasources of the port (``gofr_tpu/datasource``): the device
datasource, ``tpu``; SQL, ``sql`` (sqlite, and the Postgres and MySQL
wire clients); Redis, ``redis`` (the RESP2 client and ``InMemoryRedis``);
and the file systems, ``file`` (local, S3, GCS, FTP and SFTP). The KV,
document, wide-column and search ones are not ported (ROADMAP Queue A
item 11)."""
