"""Remote frames: a service that answers calls on named frames, its client,
and the websocket / REST servers over it (vaex_tpu/server).

The wire is vaex_tpu's: JSON messages ``{msg_id, command, auth, df,
method, args, kwargs, state}`` whose arrays are ``np.save`` bytes in
base64, so a client of either package talks to a service of the other.
The client ships its frame's state (virtual columns, selections, filter)
with every call and the service sets it on a copy of the served frame: the
copy shares the served frame's dataset and executor, so the tensors staged
on the card stay where they are, request after request.
"""

from .client import Client, connect  # noqa: F401
from .service import Service  # noqa: F401
