"""Configuration of the port's app: env-var config with file layering (a
copy of ``gofr_tpu/config``): ``get`` / ``get_or_default`` over
``./configs/.env``, overridden by ``.local.env`` or ``.{APP_ENV}.env``,
where real process environment variables always win. The ``TPU_*`` knobs
of the serving modules (``EngineConfig.from_config``,
``RouterConfig.from_config``) read through the same two methods."""

from gofr_tpu_torch.config.config import Config, EnvConfig, MapConfig, load_env_file

__all__ = ["Config", "EnvConfig", "MapConfig", "load_env_file"]
