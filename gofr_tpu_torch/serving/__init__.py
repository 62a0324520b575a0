"""Serving of the port: the engine, its device functions, the paged KV cache,
and the multi-tenant plane (LoRA adapters and tenant classes)."""

from gofr_tpu_torch.serving.lora import AdapterRegistry, LoraAdapter, make_adapter
from gofr_tpu_torch.serving.tenancy import TenantPolicy, TenantRegistry

__all__ = ["AdapterRegistry", "LoraAdapter", "TenantPolicy", "TenantRegistry", "make_adapter"]
