"""The port's local file system, row readers and observability wrapper
(``gofr_tpu_torch/datasource/file/local.py``, ``row_reader.py``,
``observability.py``) beside the JAX package's on the same operations, each
side over its own temporary directory. Compared with equality: return
values, ``FileInfo`` fields (the modification time to the second), the
bytes left on disk, raised error types, the rows read, and the observed
logs' operations and targets with the ``app_file_stats`` counts by
operation and status. Also the port's repair of ROADMAP Queue C 51:
``open`` takes a mode (``"rb"`` the reference's binary read, any other
mode ``open_file``'s) and the file system has ``exists``."""

import dataclasses
import io
import json
import os
import random

import pytest

from gofr_tpu.datasource.file import local as rlocal
from gofr_tpu.datasource.file import observability as robs
from gofr_tpu.datasource.file import row_reader as rrows
from gofr_tpu.metrics import new_metrics_manager as r_new_metrics_manager
from gofr_tpu_torch.datasource.file import local as tlocal
from gofr_tpu_torch.datasource.file import observability as tobs
from gofr_tpu_torch.datasource.file import row_reader as trows
from gofr_tpu_torch.metrics import new_metrics_manager

SIDES = {"ref": (rlocal, robs, rrows, r_new_metrics_manager),
         "port": (tlocal, tobs, trows, new_metrics_manager)}


def _info(fi) -> tuple:
    return (fi.name, fi.size, fi.is_dir, int(fi.mod_time), fi.mode())


def _tree(root: str) -> dict:
    """Every path under ``root`` with its bytes (None for a directory)."""
    out = {}
    for dirpath, dirs, files in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        for d in dirs:
            out[os.path.normpath(os.path.join(rel, d))] = None
        for f in files:
            with open(os.path.join(dirpath, f), "rb") as fh:
                out[os.path.normpath(os.path.join(rel, f))] = fh.read()
    return out


def _script(fs) -> list:
    """The contract's operations on one file system; each result or the
    type of the error raised."""
    out = []

    def step(fn, *args):
        try:
            r = fn(*args)
        except Exception as exc:  # noqa: BLE001 - the error type is the result
            out.append(("raised", type(exc).__name__))
            return None
        if isinstance(r, list):
            r = [_info(x) for x in r]
        elif hasattr(r, "mod_time"):
            r = _info(r)
        out.append(r)
        return r

    fs.mkdir("a/b/c")
    with fs.create("a/b/c/one.bin") as f:
        f.write(b"\x00\x01binary")
    with fs.open_file("a/notes.txt", "w") as f:
        f.write("alpha\n")
    with fs.open_file("a/notes.txt", "a") as f:
        f.write("beta\n")
    with fs.open_file("a/notes.txt", "r") as f:
        out.append(f.read())
    with fs.open("a/b/c/one.bin") as f:
        out.append(f.read())
    step(fs.stat, "a/b/c/one.bin")
    step(fs.stat, "a/b")
    step(fs.read_dir, "a")
    step(fs.read_dir, "a/b/c")
    step(fs.rename, "a/b/c/one.bin", "a/two.bin")
    step(fs.stat, "a/b/c/one.bin")
    step(fs.open, "missing.txt")
    step(fs.mkdir, "a", False)
    step(fs.mkdir, "solo", False)
    step(fs.chdir, "a")
    step(lambda: os.path.basename(fs.getwd()))
    step(fs.stat, "two.bin")
    step(fs.chdir, "two.bin")
    step(fs.chdir, fs.getwd() + "/..")
    step(fs.remove, "a/two.bin")
    step(fs.remove, "a/two.bin")
    step(fs.remove_all, "a/b")
    step(fs.remove_all, "nothing/here")
    step(fs.read_dir, ".")
    out.append(fs.health_check()["status"])
    out.append(sorted(fs.health_check()["details"]))
    return out


def test_local_file_system_matches_the_reference(tmp_path):
    seen = {}
    for side, (local, *_) in SIDES.items():
        root = tmp_path / side
        root.mkdir()
        fs = local.LocalFileSystem(str(root))
        for hook in (fs.use_logger, fs.use_metrics, fs.use_tracer):
            hook(None)
        fs.connect()
        seen[side] = (_script(fs), _tree(str(root)))
        fs.close()
    assert seen["port"] == seen["ref"]
    assert seen["port"][1] == {"a": None, "a/notes.txt": b"alpha\nbeta\n", "solo": None}


def test_file_info_fields_and_mode():
    for local in (rlocal, tlocal):
        fi = local.FileInfo("x.bin", 3, False, 12.5)
        assert dataclasses.astuple(fi) == ("x.bin", 3, False, 12.5) and fi.mode() == 0o644
    assert [f.name for f in dataclasses.fields(tlocal.FileInfo)] == \
        [f.name for f in dataclasses.fields(rlocal.FileInfo)]


def test_open_takes_a_mode_and_the_file_system_has_exists(tmp_path):
    """Queue C 51 on the local file system: ``open(name, "rb")`` is the
    reference's ``open(name)``; other modes are ``open_file``'s; the
    reference's ``open`` takes no mode."""
    (tmp_path / "w.bin").write_bytes(b"weights")
    port, ref = tlocal.LocalFileSystem(str(tmp_path)), rlocal.LocalFileSystem(str(tmp_path))
    with port.open("w.bin", "rb") as f, ref.open("w.bin") as g:
        assert f.read() == g.read() == b"weights"
    with port.open("t.txt", "w") as f:
        f.write("text")
    with port.open("t.txt", "r") as f:
        assert f.read() == "text"
    with pytest.raises(TypeError, match="positional argument"):
        ref.open("w.bin", "rb")
    assert port.exists("w.bin") and port.exists(str(tmp_path / "t.txt"))
    assert not port.exists("nope.bin") and not hasattr(ref, "exists")


ROWS = [{"id": i, "name": f"n{i}", "score": i * 1.5, "tags": ["a"] * (i % 3)} for i in range(7)]


@dataclasses.dataclass
class Row:
    id: int
    name: str


@pytest.mark.parametrize("layout", ["jsonl", "array", "jsonl-blank-lines"])
@pytest.mark.parametrize("as_bytes", [True, False])
def test_json_row_reader_matches_the_reference(layout, as_bytes):
    if layout == "array":
        text = json.dumps(ROWS, indent=1)
    else:
        sep = "\n\n  \n" if layout == "jsonl-blank-lines" else "\n"
        text = sep.join(json.dumps(r) for r in ROWS) + "\n"
    seen = {}
    for side, (_, _, rows, _) in SIDES.items():
        make = (lambda: io.BytesIO(text.encode())) if as_bytes else (lambda: io.StringIO(text))
        r = rows.JSONRowReader(make())
        scanned = []
        while r.next():
            target = {}
            scanned.append((r.scan(dict), r.scan(None), r.scan(Row), r.scan(target), target))
        seen[side] = (scanned, list(rows.JSONRowReader(make())))
    assert seen["port"] == seen["ref"]
    assert seen["port"][1] == ROWS and seen["port"][0][2][2] == Row(2, "n2")


@pytest.mark.parametrize("as_bytes", [True, False])
def test_text_row_reader_matches_the_reference(as_bytes):
    rng = random.Random(3)
    lines = ["".join(rng.choice("abc xyz") for _ in range(rng.randint(0, 12))) for _ in range(20)]
    text = "\n".join(lines) + "\n" + "no newline at the end"
    seen = {}
    for side, (_, _, rows, _) in SIDES.items():
        make = (lambda: io.BytesIO(text.encode())) if as_bytes else (lambda: io.StringIO(text))
        r = rows.TextRowReader(make())
        scanned = []
        while r.next():
            scanned.append(r.scan())
        seen[side] = (scanned, list(rows.TextRowReader(make())))
    assert seen["port"] == seen["ref"]
    assert seen["port"][0] == lines + ["no newline at the end"]


class RecordingLogger:
    def __init__(self) -> None:
        self.lines: list = []

    def debug(self, msg) -> None:
        self.lines.append(msg)


def test_observed_file_system_logs_and_stats_match_the_reference(tmp_path):
    """One ``FileLog`` and one ``app_file_stats`` observation (labelled by
    operation and status) per wrapped call, ``SUCCESS`` or ``ERROR``; other
    attributes pass through unobserved; the mode reaches the inner
    ``open``."""
    ops = ["create", "open", "open_file", "remove", "remove_all", "rename", "mkdir",
           "read_dir", "stat", "chdir", "getwd"]
    seen = {}
    for side, (local, obs, _, new_manager) in SIDES.items():
        root = tmp_path / side
        root.mkdir()
        m = new_manager()
        m.new_histogram("app_file_stats", "Duration of file-system operations in milliseconds")
        log = RecordingLogger()
        fs = obs.ObservedFileSystem(local.LocalFileSystem(str(root)))
        fs.use_logger(log)
        fs.use_metrics(m)
        fs.use_tracer(None)
        fs.connect()
        with fs.create("f.txt") as f:
            f.write(b"x")
        with fs.open("f.txt") as f:
            assert f.read() == b"x"
        with fs.open_file("g.txt", "w") as f:
            f.write("y")
        fs.mkdir("d/e")
        fs.read_dir(".")
        fs.stat("f.txt")
        fs.rename("f.txt", "h.txt")
        for bad in (lambda: fs.stat("nope"), lambda: fs.remove("nope"), lambda: fs.chdir("g.txt")):
            with pytest.raises(OSError):
                bad()
        fs.remove("h.txt")
        fs.remove_all("d")
        fs.chdir("."), fs.getwd()
        assert os.path.normpath(fs._abs("x")) == os.path.join(str(root), "x")  # unwrapped
        health = fs.health_check()
        fs.close()
        lines = [(type(x).__name__, x.operation, x.target) for x in log.lines]
        counts = {(op, st): m.get("app_file_stats").snapshot({"operation": op, "status": st})[1]
                  for op in ops for st in ("SUCCESS", "ERROR")}
        rendered = io.StringIO()
        log.lines[0].pretty_print(rendered)
        seen[side] = (lines, counts, health["status"], str(log.lines[0]).split()[2:],
                      rendered.getvalue().split()[2:])
    assert seen["port"] == seen["ref"]
    assert seen["port"][1][("stat", "ERROR")] == 1 and seen["port"][1][("stat", "SUCCESS")] == 1
    port_fs = tobs.ObservedFileSystem(tlocal.LocalFileSystem(str(tmp_path / "port")))
    assert port_fs.exists("g.txt") and not port_fs.exists("f.txt")
    with port_fs.open("g.txt", "r") as f:  # the mode passes through
        assert f.read() == "y"
