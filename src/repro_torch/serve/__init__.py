"""repro_torch.serve — the continuous-batching LM server of the port."""

from repro_torch.serve.engine import BatchedServer, Request, make_serve_fns
