"""Service CLI: `python -m flexpart_tpu_torch.service generate|upload`
(utils/flexpart_ifs_utils/__main__.py analog; a copy of
``flexpart_tpu/service/__main__.py``)."""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .prepare import EnvironmentParameters, prepare_job_directory
from .storage import LocalStore, s3_store, upload_output


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="flexpart_tpu_torch.service")
    sub = ap.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("generate", help="build a job directory")
    g.add_argument("-j", "--jobs-dir", required=True)
    g.add_argument("-o", "--options-dir", required=True)
    g.add_argument("-m", "--met-dir", required=True)
    g.add_argument("--site", required=True)
    g.add_argument("--runtime-config", required=True)
    u = sub.add_parser("upload", help="upload job output")
    u.add_argument("-j", "--job-dir", required=True)
    u.add_argument("--bucket", required=True)
    u.add_argument("--prefix", default="")
    u.add_argument("--store-root", default=None,
                   help="filesystem store root (default: real S3)")
    args = ap.parse_args(argv)

    if args.cmd == "generate":
        env = EnvironmentParameters.from_env()
        job = prepare_job_directory(
            args.jobs_dir, args.options_dir, args.met_dir, args.site,
            args.runtime_config, env)
        print(job)
        return 0
    store = (LocalStore(args.store_root) if args.store_root
             else s3_store())
    n = upload_output(store, args.job_dir, args.bucket, args.prefix)
    print(f"uploaded {n} objects")
    return 0


if __name__ == "__main__":
    sys.exit(main())
