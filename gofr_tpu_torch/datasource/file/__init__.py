"""File systems (reference: pkg/gofr/datasource/file/).

The FileSystem/File contracts (interface.go:12-133) with a local
implementation (local_fs.go), JSON/text RowReaders (row_reader.go), and an
observability wrapper logging every operation (observability.go). Object
stores (S3/GCS in the reference's external modules) plug in behind the
same contract; GCS is the weight-loading path in the TPU build
(SURVEY §5.4: checkpoint load = model weights through this abstraction).
SFTP (sftp.py) rides the from-scratch SSH 2.0 transport
(ssh_transport.py: curve25519 kex, ed25519 host keys, aes128-ctr +
hmac-sha2-256).

The port's copy of ``gofr_tpu/datasource/file/__init__.py``; it imports nothing of the JAX package.
"""

from gofr_tpu_torch.datasource.file.gcs import GCSProvider
from gofr_tpu_torch.datasource.file.local import LocalFileSystem
from gofr_tpu_torch.datasource.file.object_store import ObjectFileSystem, ObjectInfo
from gofr_tpu_torch.datasource.file.observability import ObservedFileSystem
from gofr_tpu_torch.datasource.file.row_reader import JSONRowReader, TextRowReader
from gofr_tpu_torch.datasource.file.s3 import S3Provider
from gofr_tpu_torch.datasource.file.sftp import SFTPFileSystem
from gofr_tpu_torch.datasource.file.ftp import FTPFileSystem

__all__ = [
    "LocalFileSystem",
    "ObservedFileSystem",
    "JSONRowReader",
    "TextRowReader",
    "ObjectFileSystem",
    "ObjectInfo",
    "GCSProvider",
    "S3Provider",
    "SFTPFileSystem",
    "FTPFileSystem",
]
