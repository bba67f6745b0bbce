"""The REST front end of the port (JAX: ``rest/``): the ``/apis/v1``
surface on the standard library's HTTP server."""
