"""HTTP on Tables + Serving: the single-server stack.

Counterpart of mmlspark_tpu/io_http (reference modules replaced:
src/io/http/ — HTTPSchema and Spark Serving's continuous and micro-batch
sources). Ported so far: the request/response records (`schema`), the
binary row protocol (`wire`), the batch-mode journal (`journal`) and
`ServingServer`, `MicroBatchQuery` and `serve_model` (`serving`), whose
resident hot path replays a fused segment's CUDA graphs on the card. The
client stack, the fleet, the gateway and the typed REST stages come with
ROADMAP Queue 1 item 11b.
"""

from .schema import (
    HTTPRequestData,
    HTTPResponseData,
    parse_request,
    make_reply,
)
from .journal import ServingJournal
from .serving import MicroBatchQuery, ServingServer, serve_model

__all__ = [
    "HTTPRequestData",
    "HTTPResponseData",
    "parse_request",
    "make_reply",
    "MicroBatchQuery",
    "ServingJournal",
    "ServingServer",
    "serve_model",
]
