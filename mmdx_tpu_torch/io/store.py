"""Object-store abstraction: the blob plane behind data/feature/training
pipelines. Copy of ``mmdx_tpu/io/store.py``.

The reference hardwires boto3/S3 for images + parquet (reference
``backend/ml/pipelines/training_pipeline.py:67,93-103``,
``raw_data_pre_preparation.py:223-272``).  We make the store pluggable:
LocalFS for dev, InMemory for tests, S3 (gated on boto3 + credentials) for
prod — all addressed by ``scheme://bucket/key`` URLs so the reference's
``s3://...`` URLs keep working.
"""
from __future__ import annotations

import io
import threading
from pathlib import Path
from urllib.parse import urlparse


def parse_url(url: str) -> tuple[str, str, str]:
    """url -> (scheme, bucket, key). Mirrors reference parse_s3_url (:99-103)."""
    p = urlparse(url)
    if not p.scheme:
        raise ValueError(f"not a store url: {url}")
    return p.scheme, p.netloc, p.path.lstrip("/")


class ObjectStore:
    scheme = "mem"
    bucket = "default"

    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> bytes:
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        raise NotImplementedError

    def list(self, prefix: str = "") -> list[str]:
        raise NotImplementedError

    def url_for(self, key: str) -> str:
        return f"{self.scheme}://{self.bucket}/{key}"


class InMemoryStore(ObjectStore):
    """Thread-safe in-memory store (the test stand-in for S3)."""

    def __init__(self, bucket: str = "test-bucket"):
        self.scheme = "mem"
        self.bucket = bucket
        self._blobs: dict[str, bytes] = {}
        self._lock = threading.Lock()

    def put(self, key: str, data: bytes) -> None:
        with self._lock:
            self._blobs[key] = bytes(data)

    def get(self, key: str) -> bytes:
        try:
            return self._blobs[key]
        except KeyError:
            raise FileNotFoundError(key) from None

    def exists(self, key: str) -> bool:
        return key in self._blobs

    def list(self, prefix: str = "") -> list[str]:
        return sorted(k for k in self._blobs if k.startswith(prefix))


class LocalFSStore(ObjectStore):
    """Filesystem-backed store rooted at a directory ("bucket")."""

    def __init__(self, root: str | Path, bucket: str | None = None):
        self.scheme = "file"
        self.root = Path(root)
        self.bucket = bucket or self.root.name
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, key: str) -> Path:
        p = (self.root / key).resolve()
        # is_relative_to, not str.startswith: a prefix check without the
        # separator admits sibling dirs sharing the root's name prefix
        # ("/data/store-backup" passes a "/data/store" startswith)
        if not p.is_relative_to(self.root.resolve()):
            raise ValueError(f"key escapes store root: {key}")
        return p

    def put(self, key: str, data: bytes) -> None:
        p = self._path(key)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_suffix(p.suffix + ".tmp")
        tmp.write_bytes(data)
        tmp.replace(p)  # atomic, like the reference bundle write (:792-794)

    def get(self, key: str) -> bytes:
        return self._path(key).read_bytes()

    def exists(self, key: str) -> bool:
        return self._path(key).exists()

    def list(self, prefix: str = "") -> list[str]:
        out = []
        for p in self.root.rglob("*"):
            if p.is_file():
                k = str(p.relative_to(self.root))
                if k.startswith(prefix) and not k.endswith(".tmp"):
                    out.append(k)
        return sorted(out)

    def url_for(self, key: str) -> str:
        # the REGISTERED handle (bucket), not the filesystem root: open_url
        # resolves "file://<bucket>/<key>" through the registry, so URLs
        # persisted in feature rows stay valid wherever the store is rooted
        # (a root-path URL only worked by accident for absolute roots)
        return f"file://{self.bucket}/{key}"


class S3Store(ObjectStore):
    """boto3-backed store (prod). Gated: requires boto3 + credentials at runtime."""

    def __init__(self, bucket: str):
        import boto3  # not baked into this env; available in prod images

        self.scheme = "s3"
        self.bucket = bucket
        self._client = boto3.client("s3")

    def put(self, key: str, data: bytes) -> None:
        self._client.put_object(Bucket=self.bucket, Key=key, Body=data)

    def get(self, key: str) -> bytes:
        bio = io.BytesIO()
        self._client.download_fileobj(self.bucket, key, bio)
        return bio.getvalue()

    def exists(self, key: str) -> bool:
        try:
            self._client.head_object(Bucket=self.bucket, Key=key)
            return True
        except Exception:
            return False

    def list(self, prefix: str = "") -> list[str]:
        # paginate: list_objects_v2 caps a single response at 1000 keys
        keys: list[str] = []
        token = None
        while True:
            kwargs = {"Bucket": self.bucket, "Prefix": prefix}
            if token:
                kwargs["ContinuationToken"] = token
            resp = self._client.list_objects_v2(**kwargs)
            keys.extend(o["Key"] for o in resp.get("Contents", []))
            if not resp.get("IsTruncated"):
                return keys
            token = resp.get("NextContinuationToken")


_REGISTRY: dict[str, ObjectStore] = {}


def register_store(store: ObjectStore) -> ObjectStore:
    _REGISTRY[f"{store.scheme}://{store.bucket}"] = store
    return store


def open_url(url: str) -> bytes:
    """Fetch a blob by store URL (the serving/training-side image fetch,
    replacing reference get_image_from_s3, training_pipeline.py:93-96)."""
    scheme, bucket, key = parse_url(url)
    handle = f"{scheme}://{bucket}"
    if handle in _REGISTRY:
        return _REGISTRY[handle].get(key)
    if scheme == "file":
        # unregistered file URL: absolute path first, then cwd-relative
        # (URLs persisted by older runs embedded the filesystem root)
        p_abs = Path(f"/{bucket}/{key}" if bucket else f"/{key}")
        if p_abs.exists():
            return p_abs.read_bytes()
        p_rel = Path(bucket) / key if bucket else Path(key)
        if p_rel.exists():
            return p_rel.read_bytes()
        raise FileNotFoundError(url)
    if scheme == "s3":
        return register_store(S3Store(bucket)).get(key)
    raise ValueError(f"no store registered for {handle}")
