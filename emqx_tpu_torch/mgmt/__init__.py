"""Management: REST API + CLI, node-local or fanned out over a cluster.

Parity: apps/emqx_management — emqx_mgmt.erl (facade), emqx_mgmt_http/
emqx_mgmt_api_*.erl (REST over minirest), emqx_mgmt_cli.erl (emqx_ctl
commands), emqx_mgmt_auth.erl (app id/secret credentials). The port's
copy of ``emqx_tpu/mgmt``.
"""

from emqx_tpu_torch.mgmt.api import make_api
from emqx_tpu_torch.mgmt.cli import Cli
from emqx_tpu_torch.mgmt.httpd import HttpServer
from emqx_tpu_torch.mgmt.mgmt import Mgmt

__all__ = ["Mgmt", "make_api", "HttpServer", "Cli"]
