"""Models of the port: the decoder-transformer sequence policy so far."""
