"""File IO of the datasets (reference wm_basicsr/utils/file_client.py and
img_util.py:imfrombytes), the port's copy of the disk and lmdb backends of
comfyui_keep_tpu/utils/file_client.py. Images decode through utils/png.py,
since the card machine has no OpenCV. The lmdb package is imported when an
lmdb client is made, and its absence raises ImportError naming it; the
memcached backend (cluster infrastructure) is not ported."""
import numpy as np

from comfyui_keep_torch.utils import png


class DiskBackend:
    def get(self, filepath) -> bytes:
        with open(filepath, "rb") as f:
            return f.read()


class LmdbBackend:
    """One read-only lmdb environment per client key (db_paths and
    client_keys, a name or a list each); get(key, client_key) is the
    value stored under the ASCII key."""

    def __init__(self, db_paths, client_keys="default", readonly=True,
                 lock=False, readahead=False, **kwargs):
        from comfyui_keep_torch.utils.lmdb_util import require_lmdb
        lmdb = require_lmdb()
        if isinstance(client_keys, str):
            client_keys = [client_keys]
        if isinstance(db_paths, str):
            db_paths = [db_paths]
        if len(client_keys) != len(db_paths):
            raise ValueError("client_keys and db_paths should have the same "
                             f"length, but got {len(client_keys)} and "
                             f"{len(db_paths)}")
        self._client = {
            k: lmdb.open(p, readonly=readonly, lock=lock,
                         readahead=readahead)
            for k, p in zip(client_keys, db_paths)}

    def get(self, filepath, client_key: str = "default") -> bytes:
        with self._client[client_key].begin(write=False) as txn:
            return txn.get(str(filepath).encode("ascii"))


class FileClient:
    _backends = {"disk": DiskBackend, "lmdb": LmdbBackend}

    def __init__(self, backend: str = "disk", **kwargs):
        if backend not in self._backends:
            raise ValueError(f"backend {backend} not supported; available: "
                             f"{list(self._backends)}")
        self.backend = backend
        self.client = self._backends[backend](**kwargs)

    def get(self, filepath, client_key: str = "default") -> bytes:
        if self.backend == "lmdb":
            return self.client.get(filepath, client_key)
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
