"""Host utilities of the port: device selection and signal handling."""
