"""Cross-device FL (Beehive analogue; counterpart of
``fedml_tpu/cross_device``): a server on the card speaking a file-payload
device protocol + simulated device clients whose training engine is the
port's local SGD on the card or the native C++ core
(:mod:`fedml_tpu_torch.native`).

Reference surface covered: ``cross_device/server_mnn/`` (server manager +
aggregator reading uploaded device model files), the device protocol
(registration/ONLINE handshake, per-round model-file exchange, FINISH), and
the native on-device trainer story (``android/fedmlsdk/MobileNN``) via the
ctypes-bridged C++ core.
"""

from .client import DeviceClientManager  # noqa: F401
from .message_define import DeviceMessage  # noqa: F401
from .runner import (build_cross_device_runner,  # noqa: F401
                     build_device_client, build_device_server,
                     run_cross_device_inproc)
from .server import DeviceAggregator, DeviceServerManager  # noqa: F401
