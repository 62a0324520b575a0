"""Datasources of the port (``gofr_tpu/datasource``): the device
datasource, ``tpu``; SQL, ``sql`` (sqlite, and the Postgres and MySQL
wire clients); Redis, ``redis`` (the RESP2 client and ``InMemoryRedis``);
the file systems, ``file`` (local, S3, GCS, FTP and SFTP); key-value,
``kv`` (in memory, a JSON file, TTLs, and DynamoDB); documents,
``document`` (embedded over sqlite, and Mongo over OP_MSG and BSON);
wide-column, ``widecolumn`` (embedded over sqlite, and Cassandra over CQL
v4); search, ``search`` (an embedded BM25 index, and Solr over HTTP); and
time series, ``timeseries`` (embedded, with the device's memory recorder).
The columnar (ClickHouse) and graph families and ``compat.py``'s facades
are not ported (ROADMAP Queue A item 11)."""
