"""Object storage for operational in/output (s3_utils.py analog; a copy
of ``flexpart_tpu/service/storage.py``).

The reference uploads job output to S3 with retries and downloads the
met archive from a bucket.  The same interface is provided over two
backends: a filesystem store (buckets are directories — used in tests
and air-gapped runs) and, when boto3 is importable, real S3."""

from __future__ import annotations

import logging
import shutil
import time
from pathlib import Path

log = logging.getLogger(__name__)

RETRIES = 3
RETRY_SLEEP = 1.0


class LocalStore:
    """Filesystem-backed object store: <root>/<bucket>/<key>."""

    def __init__(self, root):
        self.root = Path(root)

    def list_objects(self, bucket: str, prefix: str = "") -> list[str]:
        b = self.root / bucket
        if not b.is_dir():
            return []
        return sorted(str(p.relative_to(b)) for p in b.rglob("*")
                      if p.is_file()
                      and str(p.relative_to(b)).startswith(prefix))

    def download(self, bucket: str, key: str, dest) -> None:
        dest = Path(dest)
        dest.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(self.root / bucket / key, dest)

    def upload(self, src, bucket: str, key: str) -> None:
        dest = self.root / bucket / key
        dest.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(src, dest)


def s3_store(**kwargs):
    """Real S3 store; requires boto3 (not vendored — the environment
    must provide it, mirroring the reference's optional service dep)."""
    import boto3  # noqa: F401  (gated import)

    class S3Store:
        def __init__(self, **kw):
            self.client = boto3.client("s3", **kw)

        def list_objects(self, bucket, prefix=""):
            out, token = [], None
            while True:
                kw = dict(Bucket=bucket, Prefix=prefix)
                if token:
                    kw["ContinuationToken"] = token
                r = self.client.list_objects_v2(**kw)
                out += [o["Key"] for o in r.get("Contents", [])]
                if not r.get("IsTruncated"):
                    return sorted(out)
                token = r["NextContinuationToken"]

        def download(self, bucket, key, dest):
            Path(dest).parent.mkdir(parents=True, exist_ok=True)
            self.client.download_file(bucket, key, str(dest))

        def upload(self, src, bucket, key):
            self.client.upload_file(str(src), bucket, key)

    return S3Store(**kwargs)


def _with_retries(fn, *args):
    for attempt in range(RETRIES):
        try:
            return fn(*args)
        except Exception:
            if attempt == RETRIES - 1:
                raise
            log.warning("storage op failed (attempt %d), retrying",
                        attempt + 1)
            time.sleep(RETRY_SLEEP * (attempt + 1))


def upload_output(store, job_dir, bucket: str, prefix: str = "") -> int:
    """Upload every file under <job_dir>/output (s3_utils.upload_output);
    returns the number of objects uploaded."""
    outdir = Path(job_dir) / "output"
    n = 0
    for f in sorted(outdir.rglob("*")):
        if f.is_file():
            key = (f"{prefix}/" if prefix else "") \
                + str(f.relative_to(outdir))
            _with_retries(store.upload, f, bucket, key)
            n += 1
    return n


def download_keys(store, bucket: str, keys, dest_dir) -> list[Path]:
    dest_dir = Path(dest_dir)
    out = []
    for key in keys:
        dest = dest_dir / Path(key).name
        _with_retries(store.download, bucket, key, dest)
        out.append(dest)
    return out
