"""Security: visibility labels + authorizations (≙ ``geomesa_tpu.security``,
geomesa-security)."""

from geomesa_tpu_torch.security.visibility import (AuthorizationsProvider,
                                                   VisibilityError,
                                                   allowed_codes, evaluate,
                                                   parse_visibility)

__all__ = ["AuthorizationsProvider", "VisibilityError", "allowed_codes",
           "evaluate", "parse_visibility"]
