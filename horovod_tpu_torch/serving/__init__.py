"""horovod_tpu_torch.serving: continuous-batching LM inference, the port of
``horovod_tpu/serving``.

* :class:`FrontDoor` (server.py) answers ``POST /generate`` and ``GET
  /stats``/``/health``; the admission :class:`Scheduler` (scheduler.py)
  packs prompts into free decode slots at token boundaries and retires
  them at their token budget.
* :class:`DecodeEngine` (decode.py) holds the slot-batched KV caches and
  steps the flagship transformer's decode (models/transformer.py).

One process serves by stepping the engine in a loop of its own: take the
scheduler's admissions, prefill each, one ``step()``, ``on_token`` for
every live slot, ``complete`` where a request has its tokens (the order of
the JAX package's ``ServingLoop``).  ``ServingLoop``, which drives a gang in
lockstep through the eager engine's control channel, waits for the eager
engine's port.
"""

from horovod_tpu_torch.serving.decode import DecodeEngine
from horovod_tpu_torch.serving.scheduler import QueueFull, Request, Scheduler
from horovod_tpu_torch.serving.server import FrontDoor

__all__ = [
    "DecodeEngine",
    "FrontDoor",
    "QueueFull",
    "Request",
    "Scheduler",
]
