"""Minimal 3-stage SDK graph: Frontend -> Middle -> Backend.

    python -m dynamo_tpu_torch.cli.serve \
        dynamo_tpu_torch.examples.hello_world:Frontend --platform cpu

Then call the frontend endpoint from any runtime client:

    client = await drt.namespace("hello").component("frontend") \
        .endpoint("generate").client().start()
    async for item in client.generate({"text": "a b c"}): ...

The repo's ``examples/hello_world.py`` on the port's SDK. Reference
capability: examples/hello_world/hello_world.py:24-80.
"""

from dynamo_tpu_torch.sdk import depends, dynamo_endpoint, service


@service(namespace="hello")
class Backend:
    @dynamo_endpoint()
    async def generate(self, request, ctx):
        for word in request["text"].split():
            yield {"word": f"{word}-back"}


@service(namespace="hello")
class Middle:
    backend = depends(Backend)

    @dynamo_endpoint()
    async def generate(self, request, ctx):
        async for item in self.backend.generate(request):
            yield {"word": item["word"].upper()}


@service(namespace="hello")
class Frontend:
    middle = depends(Middle)

    @dynamo_endpoint()
    async def generate(self, request, ctx):
        async for item in self.middle.generate(request):
            yield item


Frontend.link(Middle).link(Backend)
