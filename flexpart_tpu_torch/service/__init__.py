"""Operational service layer (utils/flexpart_ifs_utils analog): job
preparation, object storage, CLI.

Port of ``flexpart_tpu/service/`` (a copy: it imports no JAX).  The job
script runs the port's command line, ``python -m flexpart_tpu_torch``.
YAML is read only where a runtime-configuration template is rendered, and
boto3 only where a real S3 store is made: importing this package needs
neither."""
from .prepare import (EnvironmentParameters, build_job_directory,
                      configure_namelist, generate_available,
                      prepare_job_directory, render_runtime_configuration,
                      select_files, write_job_script, write_pathnames)
from .storage import LocalStore, download_keys, s3_store, upload_output
