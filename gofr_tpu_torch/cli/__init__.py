"""CLI apps + terminal (a copy of ``gofr_tpu/cli``; reference: pkg/gofr/cmd.go +
pkg/gofr/cmd/).

``new_cmd()`` apps route subcommands with prefix matching and auto help
(cmd.go:35-164); ``cmd.Request`` parses ``-flag`` / ``key=value`` args
(cmd/request.go:14-60); responses print to stdout (cmd/responder.go). The
terminal package provides colors, spinners and progress bars
(cmd/terminal/).
"""

from gofr_tpu_torch.cli.cmd import CMDRequest, run_cmd
from gofr_tpu_torch.cli.terminal import Output, ProgressBar, Spinner

__all__ = ["run_cmd", "CMDRequest", "Output", "Spinner", "ProgressBar"]
