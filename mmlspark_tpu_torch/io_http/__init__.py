"""HTTP on Tables + Serving.

Counterpart of mmlspark_tpu/io_http (reference modules replaced:
src/io/http/ — the client stack (HTTPSchema, HTTPTransformer,
SimpleHTTPTransformer, parsers, retrying clients, batchers), Spark Serving
(HTTPSource/DistributedHTTPSource/HTTPSourceV2 continuous serving),
PartitionConsolidator, PowerBIWriter, and the Cognitive-Services-style
typed REST stages). Every module of the JAX package's io_http is here:
the request/response records (`schema`), the binary row protocol
(`wire`), the batch-mode journal (`journal`), `ServingServer`,
`MicroBatchQuery` and `serve_model`, whose resident hot path replays a
fused segment's CUDA graphs on the card, and `ServingFleet` with its
rendezvous (`serving`), the pooled client stack (`clients`), reverse
tunnels (`forwarding`), `ServingGateway` and `GatewayTier` (`gateway`),
`FleetAutoscaler` (`autoscale`), `PartitionConsolidator` (`consolidator`),
the HTTP transformers (`transformer`) and the typed REST stages
(`cognitive`, `search`, `powerbi`). All of it is host Python; a fleet
replica is a spawned process that owns its own CUDA context.
"""

from .schema import (
    HTTPRequestData,
    HTTPResponseData,
    parse_request,
    make_reply,
)
from .clients import http_send, HTTPClient, TargetPool
from .transformer import (
    HTTPTransformer,
    DistributedHTTPTransformer,
    SimpleHTTPTransformer,
    JSONInputParser,
    JSONOutputParser,
    StringOutputParser,
    CustomInputParser,
    CustomOutputParser,
)
from .forwarding import ForwardingOptions, PortForward, establish_forward
from .journal import ServingJournal
from .serving import MicroBatchQuery, ServingFleet, ServingServer, serve_model
from .gateway import ServingGateway
from .autoscale import FleetAutoscaler
from .consolidator import PartitionConsolidator
from .powerbi import PowerBIWriter
from .cognitive import (
    CognitiveServiceBase,
    TextSentiment,
    LanguageDetector,
    EntityDetector,
    KeyPhraseExtractor,
    NER,
    OCR,
    RecognizeText,
    RecognizeDomainSpecificContent,
    GenerateThumbnails,
    TagImage,
    DescribeImage,
    AnalyzeImage,
    DetectFace,
    FindSimilarFace,
    GroupFaces,
    IdentifyFaces,
    VerifyFaces,
    BingImageSearch,
)
from .search import AzureSearchWriter

__all__ = [
    "HTTPRequestData",
    "HTTPResponseData",
    "parse_request",
    "make_reply",
    "http_send",
    "HTTPClient",
    "TargetPool",
    "HTTPTransformer",
    "DistributedHTTPTransformer",
    "SimpleHTTPTransformer",
    "JSONInputParser",
    "JSONOutputParser",
    "StringOutputParser",
    "CustomInputParser",
    "CustomOutputParser",
    "MicroBatchQuery",
    "ServingJournal",
    "ServingFleet",
    "ServingServer",
    "ServingGateway",
    "FleetAutoscaler",
    "serve_model",
    "PartitionConsolidator",
    "PowerBIWriter",
    "CognitiveServiceBase",
    "TextSentiment",
    "LanguageDetector",
    "EntityDetector",
    "KeyPhraseExtractor",
    "NER",
    "OCR",
    "RecognizeText",
    "RecognizeDomainSpecificContent",
    "GenerateThumbnails",
    "TagImage",
    "DescribeImage",
    "AnalyzeImage",
    "DetectFace",
    "FindSimilarFace",
    "GroupFaces",
    "IdentifyFaces",
    "VerifyFaces",
    "BingImageSearch",
    "AzureSearchWriter",
]
