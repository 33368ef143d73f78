"""Client verbs against the cluster (reference: weed/operation/): assign,
upload and lookup over the port's RPC plane and HTTP client.  Delete,
submit and the volume tail wait for ROADMAP A4c."""
from .assign import assign
from .lookup import lookup_file_id
from .upload import upload_data

__all__ = ["assign", "lookup_file_id", "upload_data"]
