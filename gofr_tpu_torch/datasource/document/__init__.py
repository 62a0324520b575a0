"""The port's copy of ``gofr_tpu/datasource/document/__init__.py``; it imports nothing of the JAX package."""

from gofr_tpu_torch.datasource.document.embedded import EmbeddedDocumentStore, new_document_store

__all__ = ["EmbeddedDocumentStore", "new_document_store"]
