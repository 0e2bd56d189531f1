"""Elastic LM serving of the port: the decode path as a malleable job.
The replica fleet and its SLO machinery come with a later slice."""
from repro_torch.serve.replica import decode_demo, make_decode_app

__all__ = ["make_decode_app", "decode_demo"]
