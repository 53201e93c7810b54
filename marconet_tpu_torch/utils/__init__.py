"""Host-side helpers of the port: image resizes and filters, a PNG codec,
a YAML subset reader."""
