"""Single-device collectives (the LM-head cross-entropy)."""
