"""File IO of the datasets (reference wm_basicsr/utils/file_client.py and
img_util.py:imfrombytes), the port's copy of the disk backend of
comfyui_keep_tpu/utils/file_client.py. Images decode through utils/png.py,
since the card machine has no OpenCV; the lmdb backend is ROADMAP Queue 1
item 6.7."""
import numpy as np

from comfyui_keep_torch.utils import png


class DiskBackend:
    def get(self, filepath) -> bytes:
        with open(filepath, "rb") as f:
            return f.read()


class FileClient:
    _backends = {"disk": DiskBackend}

    def __init__(self, backend: str = "disk", **kwargs):
        if backend not in self._backends:
            raise ValueError(f"backend {backend} not supported; available: "
                             f"{list(self._backends)} (lmdb is ROADMAP "
                             "Queue 1 item 6.7)")
        self.backend = backend
        self.client = self._backends[backend](**kwargs)

    def get(self, filepath, client_key: str = "default") -> bytes:
        return self.client.get(filepath)


def imfrombytes(content: bytes, flag: str = "color", float32: bool = False
                ) -> np.ndarray:
    """PNG bytes -> (H, W, 3) BGR, as cv2.imdecode(buf, IMREAD_COLOR);
    float32 in [0, 1] when asked."""
    if flag != "color":
        raise ValueError(f"imfrombytes flag {flag!r}: the port reads "
                         "'color' only")
    img = png.decode_bgr(content)
    return img.astype(np.float32) / 255.0 if float32 else img
