from .jwt import (
    JwtError,
    decode_jwt,
    encode_jwt,
    gen_volume_write_jwt,
    jwt_from_request,
    verify_volume_write_jwt,
)

__all__ = [
    "JwtError",
    "decode_jwt",
    "encode_jwt",
    "gen_volume_write_jwt",
    "jwt_from_request",
    "verify_volume_write_jwt",
]
