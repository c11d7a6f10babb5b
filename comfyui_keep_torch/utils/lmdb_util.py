"""LMDB dataset builders (reference wm_basicsr/utils/lmdb_util.py:9-207),
ported from comfyui_keep_tpu/utils/lmdb_util.py without OpenCV: images are
read and written as PNG through utils/png.py.

Layout written: <name>.lmdb/{data.mdb, lock.mdb, meta_info.txt}; the keys
are the images' names without extension, and each meta line is
"<key>.png (<h>,<w>,<c>) <compress_level>". FileClient's lmdb backend
(utils/file_client.py) reads it back. The lmdb package is imported only
when a database is opened, and its absence raises ImportError naming it.
"""
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from comfyui_keep_torch.utils import png


def require_lmdb():
    """The lmdb module, or ImportError naming the package."""
    try:
        import lmdb
    except ImportError as e:
        raise ImportError("the lmdb backend needs the lmdb package") from e
    return lmdb


def read_img_worker(path, key, compress_level):
    """One PNG -> (key, its PNG bytes re-encoded at compress_level, (h, w,
    c)) (lmdb_util.py:135-156; the samples as stored, gray as c = 1)."""
    with open(path, "rb") as f:
        img = png.decode(f.read())
    h, w, c = img.shape
    return key, png.encode(img, level=compress_level), (h, w, c)


def imdecode_unchanged(buf: bytes) -> np.ndarray:
    """cv2.imdecode(buf, IMREAD_UNCHANGED) of a PNG: (H, W) gray, (H, W, 3)
    BGR or (H, W, 4) BGRA, in the file's depth."""
    img = png.decode(buf)
    if img.shape[2] == 1:
        return img[..., 0]
    order = [2, 1, 0, 3][:img.shape[2]]
    return np.ascontiguousarray(img[..., order])


class LmdbMaker:
    """The incremental builder (lmdb_util.py:159-207): put() stores encoded
    bytes under a key and records its meta line, every `batch` puts
    commit, close() commits and closes meta_info.txt."""

    def __init__(self, lmdb_path, map_size=1024 ** 4, batch=5000,
                 compress_level=1):
        lmdb = require_lmdb()
        if not str(lmdb_path).endswith(".lmdb"):
            raise ValueError("lmdb_path must end with '.lmdb'.")
        if os.path.exists(lmdb_path):
            print(f"Folder {lmdb_path} already exists. Exit.")
            sys.exit(1)
        self.lmdb_path = str(lmdb_path)
        self.batch = batch
        self.compress_level = compress_level
        self.env = lmdb.open(self.lmdb_path, map_size=map_size)
        self.txn = self.env.begin(write=True)
        self.txt_file = open(os.path.join(self.lmdb_path, "meta_info.txt"),
                             "w")
        self.counter = 0

    def put(self, img_byte, key, img_shape):
        self.counter += 1
        self.txn.put(key.encode("ascii"), img_byte)
        h, w, c = img_shape
        self.txt_file.write(f"{key}.png ({h},{w},{c}) {self.compress_level}\n")
        if self.counter % self.batch == 0:
            self.txn.commit()
            self.txn = self.env.begin(write=True)

    def close(self):
        self.txn.commit()
        self.env.close()
        self.txt_file.close()


def make_lmdb_from_imgs(data_path, lmdb_path, img_path_list, keys,
                        batch=5000, compress_level=1,
                        multiprocessing_read=False, n_thread=40,
                        map_size=None):
    """A .lmdb folder from PNG images (lmdb_util.py:9-132).
    multiprocessing_read reads and encodes them all first on n_thread
    threads (the reference's process pool); map_size defaults to ten times
    the first image's encoded size times the count."""
    require_lmdb()
    if len(img_path_list) != len(keys):
        raise ValueError("img_path_list and keys should have the same "
                         f"length, but got {len(img_path_list)} and "
                         f"{len(keys)}")
    print(f"Create lmdb for {data_path}, save to {lmdb_path}...")
    print(f"Total images: {len(img_path_list)}")
    read = {}
    if multiprocessing_read:
        with ThreadPoolExecutor(n_thread) as pool:
            for key, img_byte, shape in pool.map(
                    lambda pk: read_img_worker(os.path.join(data_path,
                                                            pk[0]),
                                               pk[1], compress_level),
                    zip(img_path_list, keys)):
                read[key] = (img_byte, shape)
        print("Finish reading images.")
    if map_size is None:
        _, img_byte, _ = read_img_worker(
            os.path.join(data_path, img_path_list[0]), keys[0],
            compress_level)
        map_size = len(img_byte) * len(img_path_list) * 10
    maker = LmdbMaker(lmdb_path, map_size=map_size, batch=batch,
                      compress_level=compress_level)
    for path, key in zip(img_path_list, keys):
        if multiprocessing_read:
            img_byte, shape = read[key]
        else:
            _, img_byte, shape = read_img_worker(
                os.path.join(data_path, path), key, compress_level)
        maker.put(img_byte, key, shape)
    maker.close()
    print(f"\nFinish writing lmdb: {lmdb_path}")


def imgs_from_lmdb(lmdb_path, keys):
    """The images stored under `keys`, decoded as cv2.imdecode(...,
    IMREAD_UNCHANGED) gives them."""
    from comfyui_keep_torch.utils.file_client import FileClient
    client = FileClient("lmdb", db_paths=[str(lmdb_path)], client_keys=["x"])
    return [imdecode_unchanged(client.get(k, "x")) for k in keys]
