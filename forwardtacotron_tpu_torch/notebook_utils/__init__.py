"""The one-class notebook API of the port (`synthesize.Synthesizer`)."""
