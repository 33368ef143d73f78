"""Client verbs against the cluster (reference: weed/operation/): assign,
upload, submit, lookup and delete over the port's RPC plane and HTTP
client.  The volume tail waits for ROADMAP A4c-4b."""
from .assign import assign
from .delete import delete_file, delete_files
from .lookup import lookup_file_id, lookup_file_id_with_auth
from .submit import submit_data
from .upload import upload_data

__all__ = [
    "assign",
    "delete_file",
    "delete_files",
    "lookup_file_id",
    "lookup_file_id_with_auth",
    "submit_data",
    "upload_data",
]
