"""Client verbs against the cluster (reference: weed/operation/): assign,
upload, submit, lookup, delete and the volume tail over the port's RPC
plane and HTTP client."""
from .assign import assign
from .delete import delete_file, delete_files
from .lookup import lookup_file_id, lookup_file_id_with_auth
from .submit import submit_data
from .tail_volume import tail_volume_from_source
from .upload import upload_data

__all__ = [
    "assign",
    "delete_file",
    "delete_files",
    "lookup_file_id",
    "lookup_file_id_with_auth",
    "submit_data",
    "tail_volume_from_source",
    "upload_data",
]
