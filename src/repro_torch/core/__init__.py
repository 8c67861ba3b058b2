"""Host-side dtANS codec (numpy), byte-equal to ``repro.core``."""
