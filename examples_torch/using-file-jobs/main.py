"""Generation jobs read from files through ``ctx.file``, their results cached
in Redis through ``ctx.redis`` (an example of the PyTorch port; the JAX
package has no counterpart).

``POST /batch/{name}`` reads ``{name}/jobs.jsonl`` (one ``{"prompt": [token
ids]}`` a line), answers each prompt from Redis, or on a miss from the
engine (greedy) and then caches it with a TTL, and writes
``{name}/results.jsonl`` (one ``{"prompt": ..., "tokens": ...}`` a line)
through the same file system. The file system can be any of
``gofr_tpu_torch.datasource.file``'s (local, S3, GCS, FTP, SFTP).

Run it from its directory, ``cd examples_torch/using-file-jobs && python
main.py``, with a Redis at ``REDIS_HOST``/``REDIS_PORT``: the app reads
``configs/.env`` there (a tiny model on the CPU, the files under
``./data``), then ``curl -X POST localhost:8000/batch/demo``. Without
Redis the handler answers 500 and ``/.well-known/health`` shows ``redis``
DOWN."""

import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from gofr_tpu_torch import serve  # noqa: E402
from gofr_tpu_torch.app import App  # noqa: E402
from gofr_tpu_torch.datasource.file import JSONRowReader, LocalFileSystem  # noqa: E402
from gofr_tpu_torch.datasource.redis import new_redis  # noqa: E402


def job_key(prompt: list[int]) -> str:
    return "jobs:" + hashlib.sha256(json.dumps(prompt).encode()).hexdigest()


def batch_handler(engine, rows=JSONRowReader, max_new_tokens: int = 32, ttl_s: float = 600.0):
    """The ``POST /batch/{name}`` handler. A sync handler: it runs on the
    app's executor and waits on the engine's futures there."""
    def handler(ctx):
        name = ctx.path_param("name")
        with ctx.file.open(f"{name}/jobs.jsonl") as f:
            prompts = [row["prompt"] for row in rows(f)]
        keys = [job_key(p) for p in prompts]
        tokens, pending = {}, {}
        for prompt, key in zip(prompts, keys):
            cached = ctx.redis.get(key)
            if cached is not None:
                tokens[key] = json.loads(cached)
            elif key not in pending:
                pending[key] = engine.submit(prompt, max_new_tokens=max_new_tokens,
                                             temperature=0.0)
        for key, fut in pending.items():
            tokens[key] = fut.result(timeout=600).token_ids
            ctx.redis.set(key, json.dumps(tokens[key]), ttl_seconds=ttl_s)
        body = "".join(json.dumps({"prompt": p, "tokens": tokens[k]}) + "\n"
                       for p, k in zip(prompts, keys))
        with ctx.file.create(f"{name}/results.jsonl") as f:
            f.write(body.encode())
        return {"jobs": len(prompts), "misses": len(pending)}
    return handler


def build_app(config=None) -> App:
    app = serve.build_app(config)  # the engine and the generation routes
    conf = app.container.config
    app.add_datasource("redis", new_redis(conf))
    app.add_datasource("file", LocalFileSystem(conf.get_or_default("FILE_ROOT", "./data")))
    app.post("/batch/{name}", batch_handler(app.container.serving))
    return app


if __name__ == "__main__":
    build_app().run()
